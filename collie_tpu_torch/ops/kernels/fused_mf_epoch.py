"""One epoch of implicit MF training: the fused kernel and its plain twin.

Port of ``collie_tpu/ops/pallas/fused_mf_epoch.py``.  The Pallas TPU kernel
``_epoch_kernel`` (``:148``, launched by ``fused_mf_epoch`` at ``:563``)
becomes the hand-written CUDA kernel in
``collie_tpu_torch/csrc/fused_mf_epoch.cu`` (see its header for the design
and the bound).  Per step of the epoch: scores of the positive and the K
negatives, the hinge / BPR / adaptive / WARP loss with optional
partial-credit metadata, the composite reduction, gradients, then dense
optax-exact Adam on both embedding tables and SGD on the item bias, with
torch-coupled weight decay.

``fused_mf_epoch`` has the JAX signature and return order.  It launches the
kernel for CUDA tensors and raises on anything it does not take; it runs
``fused_mf_epoch_plain`` only for tensors that lie on the CPU.  On CUDA it
updates the tables and moments IN PLACE (the JAX call aliases them,
``:662-663``) and returns those same tensors.  ``fused_mf_epoch.launches``
counts kernel launches (one per epoch call).

``fused_mf_epoch_plain`` is the same function as a Python loop over steps:
scores and losses through ``collie_tpu_torch.ops.losses`` under autograd, and
the hand-written optax update of ``collie_tpu_torch.training.optimizers`` —
independent of the kernel's closed-form gradients.  It returns new tensors.
"""
import ctypes
from typing import Optional, Sequence, Tuple

import torch

from collie_tpu_torch.ops import losses as L
from collie_tpu_torch.ops.kernels import _build
from collie_tpu_torch.training.optimizers import (adam_bias_corrections,
                                                  adam_direction, adam_moments)

SOURCE = 'fused_mf_epoch.cu'
#: the kernel holds an embedding row in at most 8 floats per lane of a warp
MAX_DIM = 256
LOSS_KINDS = {'hinge': 0, 'bpr': 1, 'warp': 2}


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


def fused_mf_epoch_plain(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                         users, pos, negs, mask, lr_emb, lr_bias,
                         meta_rows: Optional[torch.Tensor] = None, *,
                         K: int, adaptive: bool, loss_kind: str = 'hinge',
                         meta_weights: Sequence[float] = (),
                         wd_emb: float = 0.0, wd_bias: float = 0.0) -> Tuple[torch.Tensor, ...]:
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
    ue, ie, ib = user_emb.clone(), item_emb.clone(), item_bias.clone()
    mu_u, nu_u, mu_i, nu_i = mu_u.clone(), nu_u.clone(), mu_i.clone(), nu_i.clone()
    lr_emb, lr_bias = float(lr_emb), float(lr_bias)
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
        with torch.no_grad():
            bc1, bc2 = adam_bias_corrections(count + 1 + s)
            for emb, mu, nu, g in ((ue, mu_u, nu_u, g_u), (ie, mu_i, nu_i, g_i)):
                if wd_emb:
                    g = g + wd_emb * emb
                new_mu, new_nu = adam_moments(g, mu, nu)
                mu.copy_(new_mu)
                nu.copy_(new_nu)
                emb.add_(adam_direction(new_mu, new_nu, bc1, bc2) * (-lr_emb))
            if wd_bias:
                g_b = g_b + wd_bias * ib
            ib.add_(g_b * (-lr_bias))
    return ue, ie, ib, mu_u, nu_u, mu_i, nu_i, count + S, losses


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # pointers and the stream as c_void_p: ctypes would cut a bare int to 32 bits
    lib.collie_fused_mf_epoch.argtypes = (
        [p] * 7 + [p] * 4 + [p, p, i] + [p] * 3 + [p] * 4 + [i] * 8 + [f] * 4 + [p])
    lib.collie_fused_mf_epoch.restype = i
    lib.collie_fused_mf_epoch_max_dim.argtypes = []
    lib.collie_fused_mf_epoch_max_dim.restype = i
    return lib


def _check_id_ranges(users, pos, negs, U: int, I: int) -> None:
    """One device-to-host read: every id inside its table."""
    bad = torch.stack([(users < 0).any(), (users >= U).any(),
                       (pos < 0).any(), (pos >= I).any(),
                       (negs < 0).any(), (negs >= I).any()])
    if bool(bad.any()):
        raise ValueError(f'fused_mf_epoch: ids out of range (users in [0, {U}), '
                         f'items in [0, {I}))')


def fused_mf_epoch_cuda(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                        users, pos, negs, mask, lr_emb, lr_bias,
                        meta_rows: Optional[torch.Tensor] = None, *,
                        K: int, adaptive: bool, loss_kind: str = 'hinge',
                        meta_weights: Sequence[float] = (),
                        wd_emb: float = 0.0, wd_bias: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Launch the CUDA kernel on the current stream; updates the tables and
    moments in place."""
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
    _check_id_ranges(users, pos, negs, U, I)
    lib = _library()
    if lib.collie_fused_mf_epoch_max_dim() != MAX_DIM:
        raise RuntimeError('csrc/fused_mf_epoch.cu and its wrapper disagree on MAX_DIM')
    device = users.device
    users, pos, negs, mask = (t.contiguous() for t in (users, pos, negs, mask))
    count = torch.as_tensor(count, device=device).to(torch.int32).reshape(())
    F = len(meta_weights)
    if F:
        meta = meta_rows.to(torch.int32).contiguous()
        meta_w = torch.tensor([float(w) for w in meta_weights], dtype=torch.float32,
                              device=device)
    else:
        meta = torch.zeros((1, I), dtype=torch.int32, device=device)
        meta_w = torch.zeros(1, dtype=torch.float32, device=device)
    denoms = torch.clamp(mask.sum(dim=1), min=1.0).contiguous()
    bc1s, bc2s = adam_bias_corrections(count + 1 + torch.arange(S, device=device))
    bc1s, bc2s = bc1s.contiguous(), bc2s.contiguous()
    du = torch.zeros_like(user_emb)
    di = torch.zeros_like(item_emb)
    db = torch.zeros_like(item_bias)
    losses = torch.zeros(S, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_fused_mf_epoch(
            user_emb.data_ptr(), item_emb.data_ptr(), item_bias.data_ptr(),
            mu_u.data_ptr(), nu_u.data_ptr(), mu_i.data_ptr(), nu_i.data_ptr(),
            users.data_ptr(), pos.data_ptr(), negs.data_ptr(), mask.data_ptr(),
            meta.data_ptr(), meta_w.data_ptr(), F,
            denoms.data_ptr(), bc1s.data_ptr(), bc2s.data_ptr(),
            du.data_ptr(), di.data_ptr(), db.data_ptr(), losses.data_ptr(),
            U, I, D, S, B, K, LOSS_KINDS[loss_kind], int(bool(adaptive)),
            float(lr_emb), float(lr_bias), float(wd_emb), float(wd_bias), stream)
    if err != 0:
        raise RuntimeError(f'collie_fused_mf_epoch launch failed: cudaError_t {err}')
    fused_mf_epoch.launches += 1
    return (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count + S, losses)


def fused_mf_epoch(user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
                   users, pos, negs, mask, lr_emb, lr_bias,
                   meta_rows: Optional[torch.Tensor] = None, *,
                   K: int, adaptive: bool, loss_kind: str = 'hinge',
                   meta_weights: Sequence[float] = (),
                   wd_emb: float = 0.0, wd_bias: float = 0.0) -> Tuple[torch.Tensor, ...]:
    """Run one training epoch; returns ``(user_emb, item_emb, item_bias,
    mu_u, nu_u, mu_i, nu_i, count, losses [S])``.

    ``user_emb [U, D]``, ``item_emb [I, D]``, ``item_bias [I]`` and the Adam
    moments are float32, ``count`` the 0-d Adam step count, ``users``/``pos``
    ``[S, B]`` and ``negs [S, B, K]`` int32, ``mask [S, B]`` float32.
    ``meta_rows [F, I]`` / ``meta_weights``: per-item categorical fields and
    their partial-credit weights.  CUDA tensors go through the kernel (in
    place), CPU tensors through ``fused_mf_epoch_plain``."""
    device = users.device
    kwargs = dict(K=K, adaptive=adaptive, loss_kind=loss_kind,
                  meta_weights=tuple(meta_weights), wd_emb=wd_emb, wd_bias=wd_bias)
    args = (user_emb, item_emb, item_bias, mu_u, nu_u, mu_i, nu_i, count,
            users, pos, negs, mask, lr_emb, lr_bias, meta_rows)
    if device.type == 'cpu':
        return fused_mf_epoch_plain(*args, **kwargs)
    if device.type == 'cuda':
        return fused_mf_epoch_cuda(*args, **kwargs)
    raise ValueError(f'fused_mf_epoch runs on cuda or cpu, not {device}')


fused_mf_epoch.launches = 0
