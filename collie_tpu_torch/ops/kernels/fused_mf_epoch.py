"""One epoch of MF training, implicit or explicit: the fused kernels and
their plain twins.

Port of ``collie_tpu/ops/pallas/fused_mf_epoch.py``.  Both Pallas TPU
kernels become hand-written CUDA kernels in
``collie_tpu_torch/csrc/fused_mf_epoch.cu`` (see its header for the designs
and the bounds):

* ``_epoch_kernel`` (``:148``, launched by ``fused_mf_epoch`` at ``:563``),
  implicit data.  Per step: scores of the positive and the K negatives, the
  hinge / BPR / adaptive / WARP loss with optional partial-credit metadata,
  the composite reduction, gradients, then dense optax-exact Adam on both
  embedding tables and SGD on the item bias, with torch-coupled weight decay.
* ``_explicit_epoch_kernel`` (``:337``, launched by
  ``fused_mf_explicit_epoch`` at ``:501``), explicit ratings.  Per step:
  ``u . i + b_u + b_i`` with the optional ``y_range`` sigmoid, the MSE or MAE
  weighted mean, gradients to both tables and both biases, then Adam on the
  tables and SGD on both bias vectors.

``fused_mf_epoch`` and ``fused_mf_explicit_epoch`` have the JAX signatures
and return orders.  Each launches its kernel for CUDA tensors and raises on
anything it does not take; it runs its ``*_plain`` version only for tensors
that lie on the CPU.  On CUDA they update the tables, biases and moments IN
PLACE (the JAX calls alias them) and return those same tensors.  Ids out of
range are clamped to their table, by the kernels as by the plain versions
and the Pallas kernels; the call checks shapes and types only, so it never
waits for the card.  ``<wrapper>.launches`` counts kernel launches (one per
epoch call).

The learning rates ``lr_emb`` / ``lr_bias`` are Python floats or 0-d
tensors, and ``live`` is None or a 0-d bool / integer tensor: the kernels
read both from device memory, so a whole fit's device schedulers and its
early stop reach them without a host sync (no wrapper calls ``float()`` or
``.item()`` on a device value).  A falsy ``live`` is a skipped epoch: the
state and the Adam count come back as they went in, the losses are NaN (the
JAX whole fit's skip branch).  The plain versions take the same arguments
with the same meaning: they run the epoch, then select the old state where
``live`` is false.

The plain versions are the same functions as Python loops over steps: the
forward pass and the loss through ``collie_tpu_torch.ops.losses`` under
autograd, and the hand-written optax update of
``collie_tpu_torch.training.optimizers`` (``_optax_step``, shared by both) —
independent of the kernels' closed-form gradients.  They return new tensors.
"""
import ctypes
import math
from typing import List, Optional, Sequence, Tuple

import torch

from collie_tpu_torch.ops import losses as L
from collie_tpu_torch.ops.kernels import _build
from collie_tpu_torch.training.optimizers import (adam_bias_corrections,
                                                  adam_direction, adam_moments)

SOURCE = 'fused_mf_epoch.cu'
#: the kernel holds an embedding row in at most 8 floats per lane of a warp
MAX_DIM = 256
LOSS_KINDS = {'hinge': 0, 'bpr': 1, 'warp': 2}
EXPLICIT_LOSS_KINDS = {'mse': 0, 'mae': 1}


def _check_inputs(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                  users, pos, negs, mask, meta_rows, K, loss_kind, meta_weights):
    floats = (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, mask)
    ints = (users, pos, negs)
    tensors = floats + ints + ((meta_rows,) if meta_rows is not None else ())
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'fused_mf_epoch: inputs on several devices {devices}')
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError('fused_mf_epoch: tables, moments and mask must be float32, got '
                        f'{[t.dtype for t in floats]}')
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError('fused_mf_epoch: users, pos and negs must be int32, got '
                        f'{[t.dtype for t in ints]}')
    if loss_kind not in LOSS_KINDS:
        raise ValueError(f'loss_kind must be one of {sorted(LOSS_KINDS)}, not {loss_kind!r}')
    if user_emb.dim() != 2 or item_emb.dim() != 2:
        raise ValueError('user_emb and item_emb must be 2-D')
    U, D = user_emb.shape
    I = item_emb.shape[0]
    if item_emb.shape[1] != D or tuple(item_bias.shape) != (I,):
        raise ValueError('item_emb must be [I, D] and item_bias [I]')
    if mu_u.shape != user_emb.shape or nu_u.shape != user_emb.shape \
            or mu_i.shape != item_emb.shape or nu_i.shape != item_emb.shape:
        raise ValueError('moments must have their tables\' shapes')
    if users.dim() != 2 or pos.shape != users.shape or mask.shape != users.shape:
        raise ValueError('users, pos and mask must be [S, B]')
    S, B = users.shape
    if tuple(negs.shape) != (S, B, K):
        raise ValueError(f'negs must be [S, B, K] = {(S, B, K)}, got {tuple(negs.shape)}')
    if K < 1 or B < 1 or U < 1 or I < 1:
        raise ValueError(f'empty shapes: U={U} I={I} B={B} K={K}')
    if torch.as_tensor(count).numel() != 1:
        raise ValueError('count must be a scalar')
    if meta_weights:
        if meta_rows is None or meta_rows.dim() != 2 \
                or tuple(meta_rows.shape) != (len(meta_weights), I):
            raise ValueError(f'meta_rows must be [F, I] = {(len(meta_weights), I)}')
        if meta_rows.dtype not in (torch.int32, torch.int64):
            raise TypeError(f'meta_rows must be integer, got {meta_rows.dtype}')
    return U, I, D, S, B


def _select_loss(loss_kind: str, adaptive: bool):
    if loss_kind == 'warp':
        return L.warp_loss
    if loss_kind == 'hinge':
        return L.adaptive_hinge_loss if adaptive else L.hinge_loss
    return L.adaptive_bpr_loss if adaptive else L.bpr_loss


def _optax_step(tables, biases, t, lr_emb, lr_bias, wd_emb: float, wd_bias: float) -> None:
    """One optimizer step in place, the plain versions' one copy of the
    update: optax Adam (step count ``t``) with torch-coupled decay on each
    ``(table, mu, nu, grad)``, sgd with coupled decay on each ``(bias, grad)``."""
    with torch.no_grad():
        bc1, bc2 = adam_bias_corrections(t)
        for emb, mu, nu, g in tables:
            if wd_emb:
                g = g + wd_emb * emb
            new_mu, new_nu = adam_moments(g, mu, nu)
            mu.copy_(new_mu)
            nu.copy_(new_nu)
            emb.add_(adam_direction(new_mu, new_nu, bc1, bc2) * (-lr_emb))
        for bias, g in biases:
            if wd_bias:
                g = g + wd_bias * bias
            bias.add_(g * (-lr_bias))


def _lr_value(lr, device) -> torch.Tensor:
    """A learning rate (Python float or 0-d tensor) as a 0-d float32 tensor
    on ``device``: a float is filled there, a tensor is cast, neither is
    read back."""
    if torch.is_tensor(lr):
        return lr.to(device=device, dtype=torch.float32).reshape(())
    return torch.full((), float(lr), dtype=torch.float32, device=device)


def _live_flag(live, device) -> torch.Tensor:
    """``live`` (None: 1) as a contiguous 0-d int32 tensor on ``device``."""
    if live is None:
        return torch.ones((), dtype=torch.int32, device=device)
    if not torch.is_tensor(live) or live.numel() != 1:
        raise ValueError('live must be None or a one-element tensor')
    return live.to(device=device, dtype=torch.int32).reshape(()).contiguous()


def _skip_unless_live(live, new: Sequence[torch.Tensor], old: Sequence[torch.Tensor],
                      count, S: int, losses) -> Tuple[list, torch.Tensor, torch.Tensor]:
    """The plain versions' ``live`` select: ``(state, count, losses)`` of
    the epoch, or of a skipped one (the old state and count, NaN losses)."""
    if live is None:
        return list(new), count + S, losses
    on = _live_flag(live, count.device) != 0
    return ([torch.where(on, a, b) for a, b in zip(new, old)],
            torch.where(on, count + S, count),
            torch.where(on, losses, torch.full_like(losses, float('nan'))))


def fused_mf_epoch_plain(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                         users, pos, negs, mask, lr_emb, lr_bias,
                         meta_rows: Optional[torch.Tensor] = None, *,
                         K: int, adaptive: bool, loss_kind: str = 'hinge',
                         meta_weights: Sequence[float] = (),
                         wd_emb: float = 0.0, wd_bias: float = 0.0,
                         live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch ``fused_mf_epoch``: a loop over steps, losses under
    autograd, the hand-written optax update.  Used for CPU tensors and as the
    kernel's reference; returns new tensors."""
    _check_inputs(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                  users, pos, negs, mask, meta_rows, K, loss_kind, meta_weights)
    S = users.shape[0]
    I = item_emb.shape[0]
    loss_fn = _select_loss(loss_kind, adaptive)
    metadata = ({f: meta_rows[f] for f in range(len(meta_weights))}
                if meta_weights else None)
    weights = {f: float(w) for f, w in enumerate(meta_weights)} if meta_weights else None
    count = torch.as_tensor(count, device=users.device).to(torch.int32).reshape(())
    old = (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i)
    ue, ie, ib, mu_u, nu_u, mu_i, nu_i = (t.clone() for t in old)
    lr_emb, lr_bias = _lr_value(lr_emb, users.device), _lr_value(lr_bias, users.device)
    losses = torch.empty(S, dtype=torch.float32, device=users.device)
    for s in range(S):
        ue_g = ue.detach().requires_grad_()
        ie_g = ie.detach().requires_grad_()
        ib_g = ib.detach().requires_grad_()
        u = users[s].long().clamp(0, ue.shape[0] - 1)
        p = pos[s].long().clamp(0, I - 1)
        n = negs[s].long().clamp(0, I - 1).T                     # [K, B]
        ur = ue_g[u]
        pos_scores = (ur * ie_g[p]).sum(dim=1) + ib_g[p]
        neg_scores = (ur[None] * ie_g[n]).sum(dim=2) + ib_g[n]   # [K, B]
        loss = loss_fn(pos_scores, neg_scores, num_items=I,
                       positive_items=p, negative_items=n,
                       metadata=metadata, metadata_weights=weights,
                       sample_weights=mask[s])
        g_u, g_i, g_b = torch.autograd.grad(loss, (ue_g, ie_g, ib_g))
        losses[s] = loss.detach()
        _optax_step(((ue, mu_u, nu_u, g_u), (ie, mu_i, nu_i, g_i)), ((ib, g_b),),
                    count + 1 + s, lr_emb, lr_bias, wd_emb, wd_bias)
    state, count, losses = _skip_unless_live(live, (ue, ie, ib, mu_u, nu_u, mu_i, nu_i), old,
                                             count, S, losses)
    return (*state, count, losses)


#: the C interface's version, ``collie_fused_mf_epoch_abi()`` (3: the
#: fixed-point accumulators, the loss partials and the overflow word)
ABI = 3
#: the loss partials' length, ``collie_fused_mf_epoch_max_grid()``
MAX_GRID = 1024


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, abi=('collie_fused_mf_epoch_abi', ABI))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers and the stream as c_void_p: ctypes would cut a bare int to 32 bits
    lib.collie_fused_mf_epoch.argtypes = (
        [p] * 7 + [p] * 4 + [p, p, i] + [p] * 3 + [p] * 8 + [i] * 8 + [p, p] + [f] * 2 + [p])
    lib.collie_fused_mf_epoch.restype = i
    lib.collie_fused_mf_explicit_epoch.argtypes = (
        [p] * 24 + [i] * 7 + [f] * 2 + [p, p] + [f] * 2 + [p])
    lib.collie_fused_mf_explicit_epoch.restype = i
    for name, want in (('collie_fused_mf_epoch_max_dim', MAX_DIM),
                       ('collie_fused_mf_epoch_max_grid', MAX_GRID)):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [], i
        if fn() != want:
            raise RuntimeError(f'csrc/fused_mf_epoch.cu and its wrapper disagree on {name}')
    return lib


def _zeroed(device, *shapes, dtype=torch.float32) -> List[torch.Tensor]:
    """Zeroed tensors of ``shapes`` cut from one allocation (one memset on
    the card), each starting on a 16-byte boundary for the kernel's 16-byte
    accesses."""
    sizes = [math.prod(shape) for shape in shapes]
    per_16 = 16 // torch.empty((), dtype=dtype).element_size()
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + -(-n // per_16) * per_16)
    flat = torch.zeros(starts[-1], dtype=dtype, device=device)
    return [flat[a:a + n].view(shape) for a, n, shape in zip(starts, sizes, shapes)]


def _scratch(device, S: int, *gradients: torch.Tensor) -> List[torch.Tensor]:
    """The launch's zeroed scratch: one fixed-point accumulator a gradient
    (``2 n`` int64 words, the lo words then the hi words), then the
    per-step losses, the blocks' loss partials, the overflow word and the
    grid-barrier word."""
    accumulators = _zeroed(device, *[(2 * g.numel(),) for g in gradients], dtype=torch.int64)
    losses, partials, overflow, barrier = _zeroed(device, (S,), (MAX_GRID,), (1,), (1,))
    return [*accumulators, losses, partials, overflow, barrier]


def _timeline_ptr(timeline: Optional[torch.Tensor], S: int, device) -> Optional[int]:
    """The address of ``timeline``, an int64 tensor of ``2 S + 1`` device
    clock stamps (ns): the launch's start, then the end of each step's step
    phase and of its update phase; None when no timeline is asked for."""
    if timeline is None:
        return None
    if timeline.dtype != torch.int64 or timeline.device != device \
            or timeline.shape != (2 * S + 1,) or not timeline.is_contiguous():
        raise ValueError(f'timeline must be a contiguous int64 [{2 * S + 1}] tensor on {device}')
    return timeline.data_ptr()


def fused_mf_epoch_cuda(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                        users, pos, negs, mask, lr_emb, lr_bias,
                        meta_rows: Optional[torch.Tensor] = None, *,
                        K: int, adaptive: bool, loss_kind: str = 'hinge',
                        meta_weights: Sequence[float] = (),
                        wd_emb: float = 0.0, wd_bias: float = 0.0,
                        live: Optional[torch.Tensor] = None,
                        timeline: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on the current stream; updates the tables and
    moments in place.  ``timeline``: see ``_timeline_ptr``."""
    U, I, D, S, B = _check_inputs(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i,
                                  count, users, pos, negs, mask, meta_rows, K, loss_kind,
                                  meta_weights)
    state = (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i)
    if users.device.type != 'cuda':
        raise ValueError('fused_mf_epoch_cuda takes CUDA tensors')
    if not all(t.is_contiguous() for t in state):
        raise ValueError('fused_mf_epoch_cuda updates the tables and moments in place and '
                         'takes them contiguous')
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f'the kernel supports 1 <= embedding_dim <= {MAX_DIM}, got {D}')
    lib = _library()
    device = users.device
    users, pos, negs, mask = (t.contiguous() for t in (users, pos, negs, mask))
    count = torch.as_tensor(count, device=device).to(torch.int32).reshape(())
    F = len(meta_weights)
    meta = meta_rows.to(torch.int32).contiguous() if F else None
    meta_w = torch.stack([_lr_value(w, device) for w in meta_weights]) if F else None
    lrs = torch.stack([_lr_value(lr_emb, device), _lr_value(lr_bias, device)])
    live = _live_flag(live, device)
    denoms = torch.clamp(mask.sum(dim=1), min=1.0).contiguous()
    bc1s, bc2s = adam_bias_corrections(count + 1 + torch.arange(S, device=device))
    bc1s, bc2s = bc1s.contiguous(), bc2s.contiguous()
    du, di, db, losses, partials, overflow, barrier = _scratch(device, S, user_emb, item_emb,
                                                               item_bias)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_fused_mf_epoch(
            user_emb.data_ptr(), item_emb.data_ptr(), item_bias.data_ptr(),
            mu_u.data_ptr(), nu_u.data_ptr(), mu_i.data_ptr(), nu_i.data_ptr(),
            users.data_ptr(), pos.data_ptr(), negs.data_ptr(), mask.data_ptr(),
            meta.data_ptr() if F else None, meta_w.data_ptr() if F else None, F,
            denoms.data_ptr(), bc1s.data_ptr(), bc2s.data_ptr(),
            du.data_ptr(), di.data_ptr(), db.data_ptr(), losses.data_ptr(), partials.data_ptr(),
            overflow.data_ptr(), barrier.data_ptr(), _timeline_ptr(timeline, S, device),
            U, I, D, S, B, K, LOSS_KINDS[loss_kind], int(bool(adaptive)),
            lrs.data_ptr(), live.data_ptr(), float(wd_emb), float(wd_bias), stream)
    if err != 0:
        raise RuntimeError(f'collie_fused_mf_epoch launch failed: cudaError_t {err}')
    fused_mf_epoch.launches += 1
    return (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count + S * live, losses)


def fused_mf_epoch(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                   users, pos, negs, mask, lr_emb, lr_bias,
                   meta_rows: Optional[torch.Tensor] = None, *,
                   K: int, adaptive: bool, loss_kind: str = 'hinge',
                   meta_weights: Sequence[float] = (),
                   wd_emb: float = 0.0, wd_bias: float = 0.0,
                   live: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, ...]:
    """Run one training epoch; returns ``(user_emb, item_emb, item_bias,
    mu_u, nu_u, mu_i, nu_i, count, losses [S])``.

    ``user_emb [U, D]``, ``item_emb [I, D]``, ``item_bias [I]`` and the Adam
    moments are float32, ``count`` the 0-d Adam step count, ``users``/``pos``
    ``[S, B]`` and ``negs [S, B, K]`` int32, ``mask [S, B]`` float32.
    ``meta_rows [F, I]`` / ``meta_weights``: per-item categorical fields and
    their partial-credit weights.  ``lr_emb`` / ``lr_bias``: floats or 0-d
    tensors; ``live``: see the module docstring.  CUDA tensors go through
    the kernel (in place), CPU tensors through ``fused_mf_epoch_plain``."""
    device = users.device
    kwargs = dict(K=K, adaptive=adaptive, loss_kind=loss_kind,
                  meta_weights=tuple(meta_weights), wd_emb=wd_emb, wd_bias=wd_bias, live=live)
    args = (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
            users, pos, negs, mask, lr_emb, lr_bias, meta_rows)
    if device.type == 'cpu':
        return fused_mf_epoch_plain(*args, **kwargs)
    if device.type == 'cuda':
        return fused_mf_epoch_cuda(*args, **kwargs)
    raise ValueError(f'fused_mf_epoch runs on cuda or cpu, not {device}')


fused_mf_epoch.launches = 0


# ------------------------------------------------------------------ explicit


def _check_explicit_inputs(user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i,
                           count, users, items, ratings, mask, loss_kind, y_range):
    floats = (user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i, ratings, mask)
    ints = (users, items)
    devices = {t.device for t in floats + ints}
    if len(devices) != 1:
        raise ValueError(f'fused_mf_explicit_epoch: inputs on several devices {devices}')
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError('fused_mf_explicit_epoch: tables, biases, moments, ratings and mask '
                        f'must be float32, got {[t.dtype for t in floats]}')
    if any(t.dtype != torch.int32 for t in ints):
        raise TypeError('fused_mf_explicit_epoch: users and items must be int32, got '
                        f'{[t.dtype for t in ints]}')
    if loss_kind not in EXPLICIT_LOSS_KINDS:
        raise ValueError(f'loss_kind must be one of {sorted(EXPLICIT_LOSS_KINDS)}, '
                         f'not {loss_kind!r}')
    if y_range is not None and len(tuple(y_range)) != 2:
        raise ValueError(f'y_range must be (min, max), not {y_range!r}')
    if user_emb.dim() != 2 or item_emb.dim() != 2:
        raise ValueError('user_emb and item_emb must be 2-D')
    U, D = user_emb.shape
    I = item_emb.shape[0]
    if item_emb.shape[1] != D or tuple(user_bias.shape) != (U,) \
            or tuple(item_bias.shape) != (I,):
        raise ValueError('item_emb must be [I, D], user_bias [U] and item_bias [I]')
    if mu_u.shape != user_emb.shape or nu_u.shape != user_emb.shape \
            or mu_i.shape != item_emb.shape or nu_i.shape != item_emb.shape:
        raise ValueError('moments must have their tables\' shapes')
    if users.dim() != 2 or any(t.shape != users.shape for t in (items, ratings, mask)):
        raise ValueError('users, items, ratings and mask must be [S, B]')
    S, B = users.shape
    if B < 1 or U < 1 or I < 1:
        raise ValueError(f'empty shapes: U={U} I={I} B={B}')
    if torch.as_tensor(count).numel() != 1:
        raise ValueError('count must be a scalar')
    return U, I, D, S, B


def fused_mf_explicit_epoch_plain(user_emb, item_emb, user_bias, item_bias,
                                  mu_u, nu_u, mu_i, nu_i, count,
                                  users, items, ratings, mask, lr_emb, lr_bias, *,
                                  loss_kind: str = 'mse',
                                  y_range: Optional[Tuple[float, float]] = None,
                                  wd_emb: float = 0.0, wd_bias: float = 0.0,
                                  live: Optional[torch.Tensor] = None
                                  ) -> Tuple[torch.Tensor, ...]:
    """Plain PyTorch ``fused_mf_explicit_epoch``: a loop over steps, MF's
    score and ``mse_loss``/``mae_loss`` under autograd, the hand-written optax
    update.  Used for CPU tensors and as the kernel's reference; returns new
    tensors."""
    U, I, _, S, _ = _check_explicit_inputs(user_emb, item_emb, user_bias, item_bias, mu_u,
                                           nu_u, mu_i, nu_i, count, users, items, ratings,
                                           mask, loss_kind, y_range)
    loss_fn = L.LOSSES[loss_kind]
    count = torch.as_tensor(count, device=users.device).to(torch.int32).reshape(())
    old = (user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i)
    ue, ie, ub, ib, mu_u, nu_u, mu_i, nu_i = (t.clone() for t in old)
    lr_emb, lr_bias = _lr_value(lr_emb, users.device), _lr_value(lr_bias, users.device)
    losses = torch.empty(S, dtype=torch.float32, device=users.device)
    for s in range(S):
        leaves = [t.detach().requires_grad_() for t in (ue, ie, ub, ib)]
        ue_g, ie_g, ub_g, ib_g = leaves
        u = users[s].long().clamp(0, U - 1)
        it = items[s].long().clamp(0, I - 1)
        preds = (ue_g[u] * ie_g[it]).sum(dim=1) + ib_g[it] + ub_g[u]
        if y_range is not None:
            preds = torch.sigmoid(preds) * (y_range[1] - y_range[0]) + y_range[0]
        loss = loss_fn(preds, ratings[s], sample_weights=mask[s])
        g_u, g_i, g_ub, g_ib = torch.autograd.grad(loss, leaves)
        losses[s] = loss.detach()
        _optax_step(((ue, mu_u, nu_u, g_u), (ie, mu_i, nu_i, g_i)), ((ub, g_ub), (ib, g_ib)),
                    count + 1 + s, lr_emb, lr_bias, wd_emb, wd_bias)
    state, count, losses = _skip_unless_live(
        live, (ue, ie, ub, ib, mu_u, nu_u, mu_i, nu_i), old, count, S, losses)
    return (*state, count, losses)


def fused_mf_explicit_epoch_cuda(user_emb, item_emb, user_bias, item_bias,
                                 mu_u, nu_u, mu_i, nu_i, count,
                                 users, items, ratings, mask, lr_emb, lr_bias, *,
                                 loss_kind: str = 'mse',
                                 y_range: Optional[Tuple[float, float]] = None,
                                 wd_emb: float = 0.0, wd_bias: float = 0.0,
                                 live: Optional[torch.Tensor] = None,
                                 timeline: Optional[torch.Tensor] = None
                                 ) -> Tuple[torch.Tensor, ...]:
    """Launch the explicit CUDA kernel on the current stream; updates the
    tables, biases and moments in place.  ``timeline``: see
    ``_timeline_ptr``."""
    U, I, D, S, B = _check_explicit_inputs(user_emb, item_emb, user_bias, item_bias, mu_u,
                                           nu_u, mu_i, nu_i, count, users, items, ratings,
                                           mask, loss_kind, y_range)
    state = (user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i)
    if users.device.type != 'cuda':
        raise ValueError('fused_mf_explicit_epoch_cuda takes CUDA tensors')
    if not all(t.is_contiguous() for t in state):
        raise ValueError('fused_mf_explicit_epoch_cuda updates the tables, biases and moments '
                         'in place and takes them contiguous')
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f'the kernel supports 1 <= embedding_dim <= {MAX_DIM}, got {D}')
    lib = _library()
    device = users.device
    users, items, ratings, mask = (t.contiguous() for t in (users, items, ratings, mask))
    count = torch.as_tensor(count, device=device).to(torch.int32).reshape(())
    denoms = torch.clamp(mask.sum(dim=1), min=1.0).contiguous()
    bc1s, bc2s = adam_bias_corrections(count + 1 + torch.arange(S, device=device))
    bc1s, bc2s = bc1s.contiguous(), bc2s.contiguous()
    du, di, dbu, dbi, losses, partials, overflow, barrier = _scratch(
        device, S, user_emb, item_emb, user_bias, item_bias)
    y_lo, y_span = ((float(y_range[0]), float(y_range[1] - y_range[0]))
                    if y_range is not None else (0.0, 1.0))
    lrs = torch.stack([_lr_value(lr_emb, device), _lr_value(lr_bias, device)])
    live = _live_flag(live, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_fused_mf_explicit_epoch(
            user_emb.data_ptr(), item_emb.data_ptr(), user_bias.data_ptr(),
            item_bias.data_ptr(),
            mu_u.data_ptr(), nu_u.data_ptr(), mu_i.data_ptr(), nu_i.data_ptr(),
            users.data_ptr(), items.data_ptr(), ratings.data_ptr(), mask.data_ptr(),
            denoms.data_ptr(), bc1s.data_ptr(), bc2s.data_ptr(),
            du.data_ptr(), di.data_ptr(), dbu.data_ptr(), dbi.data_ptr(), losses.data_ptr(),
            partials.data_ptr(), overflow.data_ptr(), barrier.data_ptr(),
            _timeline_ptr(timeline, S, device),
            U, I, D, S, B, EXPLICIT_LOSS_KINDS[loss_kind], int(y_range is not None), y_lo, y_span,
            lrs.data_ptr(), live.data_ptr(), float(wd_emb), float(wd_bias), stream)
    if err != 0:
        raise RuntimeError(f'collie_fused_mf_explicit_epoch launch failed: cudaError_t {err}')
    fused_mf_explicit_epoch.launches += 1
    return (user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i,
            count + S * live, losses)


def fused_mf_explicit_epoch(user_emb, item_emb, user_bias, item_bias,
                            mu_u, nu_u, mu_i, nu_i, count,
                            users, items, ratings, mask, lr_emb, lr_bias, *,
                            loss_kind: str = 'mse',
                            y_range: Optional[Tuple[float, float]] = None,
                            wd_emb: float = 0.0, wd_bias: float = 0.0,
                            live: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, ...]:
    """Run one explicit-feedback training epoch; returns ``(user_emb,
    item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i, count,
    losses [S])``.

    ``user_emb [U, D]``, ``item_emb [I, D]``, the biases ``[U]``/``[I]`` and
    the Adam moments are float32, ``count`` the 0-d Adam step count,
    ``users``/``items [S, B]`` int32, ``ratings``/``mask [S, B]`` float32.
    ``loss_kind`` is ``'mse'`` or ``'mae'``; ``y_range = (min, max)`` applies
    MF's sigmoid rescale; ``lr_emb`` / ``lr_bias`` and ``live`` as for
    ``fused_mf_epoch``.  CUDA tensors go through the kernel (in place), CPU
    tensors through ``fused_mf_explicit_epoch_plain``."""
    device = users.device
    kwargs = dict(loss_kind=loss_kind, y_range=tuple(y_range) if y_range is not None else None,
                  wd_emb=wd_emb, wd_bias=wd_bias, live=live)
    args = (user_emb, item_emb, user_bias, item_bias, mu_u, nu_u, mu_i, nu_i, count,
            users, items, ratings, mask, lr_emb, lr_bias)
    if device.type == 'cpu':
        return fused_mf_explicit_epoch_plain(*args, **kwargs)
    if device.type == 'cuda':
        return fused_mf_explicit_epoch_cuda(*args, **kwargs)
    raise ValueError(f'fused_mf_explicit_epoch runs on cuda or cpu, not {device}')


fused_mf_explicit_epoch.launches = 0
