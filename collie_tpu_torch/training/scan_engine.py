"""Whole-epoch training: the epoch is built on the device, then trained.

Port of ``collie_tpu/training/scan_engine.py`` for in-memory loaders,
implicit and explicit, on one device or a mesh.  Per epoch the interaction ids (and, for
explicit data, the ratings) live on the device; the engine shuffles them with
the Feistel permutation, samples every negative of an implicit epoch in one
pass of an exact complement sampler (or draws them uniformly for an
approximate loader), and then trains:

* through a fused kernel (``ops/kernels/fused_mf_epoch.py``: ``fused_mf_epoch``
  for implicit data, ``fused_mf_explicit_epoch`` for ratings), one call per
  epoch, when the model is an MF in the kernel's envelope
  (``_fused_epoch_config``) and lives on ``cuda``;
* otherwise through the generic epoch: per step, ``calculate_loss`` under
  autograd and each optimizer's update (the JAX package's ``lax.scan`` body
  as a Python loop); a model with dropout gets one generator per step,
  seeded from the epoch and the step index (``dropout_step_seeds``).  A
  model with the fused table layout (``supports_fused_tables``) is carried
  through the epoch on its fused tables (``train_step``'s
  ``fused_tables``), and the epoch returns the named layout.  On
  the CPU the generic epoch runs, as the JAX package does off the TPU;
  ``fused=True`` makes a CPU model take the fused function's plain
  version, and ``fused=False`` makes any model take the generic epoch (the
  JAX package's ``COLLIE_TPU_FUSED_EPOCH=0``).

There is no path on which a CUDA model inside the envelope trains without
the kernel: if the kernel cannot launch, the epoch raises.

The out-of-core tier (``hdf5_chunk_plan``, ``draw_chunk``,
``build_hdf5_chunk_make``; ``collie_tpu/training/scan_engine.py:691-800``)
trains an ``HDF5InteractionsDataLoader`` one chunk of steps at a time: the
trainer copies each chunk's ids to the device, and the chunk function
shuffles them inside the chunk, draws its approximate negatives and runs
the generic step over them.

Routing knobs, read when the epoch functions are built, where the JAX engine
reads them: ``COLLIE_TPU_FUSED_EPOCH`` (``auto``, the default: the kernel on
``cuda`` inside the envelope; ``1``: the fused function on any device inside
the envelope, its plain version on the CPU, the generic epoch outside it;
``0``: the generic epoch) for a trainer's ``fused=None``;
``COLLIE_TPU_FUSED_TABLES=0`` keeps the generic epoch on the named table
layout; ``COLLIE_TPU_SLOT_EPOCH=0`` sends the bucketed sampler down the
reorder path (below).  Every epoch shuffles through the Feistel
permutation.  ``calculate_loss`` reads two more at each call, as
the JAX package reads them when it traces a step:
``COLLIE_TPU_SPARSE_ADAPTIVE=0`` keeps its dense form and
``COLLIE_TPU_BF16_SELECT=0`` makes MF's selection pass float32.

An epoch function takes an optional ``live`` flag (a 0-d bool tensor): a
false ``live`` is a skipped epoch, the JAX whole fit's ``lax.cond`` skip
branch, which leaves params and optimizer states as they were (the fused
kernels return before touching them; the generic epoch runs and then
selects the old state with one ``torch.where`` per tensor) and reports a
NaN loss.  ``build_scan_fit_fn`` strings epochs into a block of the whole
fit (``collie_tpu/training/scan_engine.py:815-946``) with the schedulers,
early stopping and the NaN trip on the device.  On the card nothing in an
epoch or a block waits for the host: the shuffle is a kernel, the samplers
and the batch assembly use no boolean masks or host reads, the learning
rates and the live flag reach the kernels in device memory, and the epoch's
time split is kept as CUDA events, read after the caller's next sync.

Exact sampling takes one of two samplers (``select_sampler``):
``COLLIE_TPU_SAMPLER`` (``auto``, the default, or ``bucketed``; any other
value means ``csr``) and, for ``auto``, the table budget
``COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB`` (default 1024): the degree-bucketed
tables when they fit it, else the CSR tables (a budget of 0 routes
``auto`` to ``csr``).  The JAX engine's padded sampler
(``scan_engine.py:291-306``) is bit-identical to its CSR sampler, and its
``auto`` never takes it, so ``COLLIE_TPU_SAMPLER=padded`` gives the CSR
sampler's identical negatives here.  The bucketed tables are built on the
model's device from the ids the epoch uploads
(``build_bucketed_complement_tables_torch``), and sized from the degrees
that build counts there (``BucketedPlan.table_bytes``); the CSR tables are
built on the host and uploaded.  The bucketed tables take at least 512 B a user, so above
2,097,152 users the default budget routes to the CSR sampler, whose tables
grow with the interactions alone.

Epoch layouts follow the JAX engine: ``(row, col)`` ids packed into one
int32 where they fit; the slot-domain one-gather epoch when shuffling
packable implicit ids with at most 2% bucket-pad slots (``:331-375``,
``:409-445``), whose pad slots are clamped into the item range before any
gather (``_unpack_rows``, ``:496-527``); the reorder path otherwise, and
always for explicit data (``items`` and ``ratings`` gathered by the same
permutation, ``:465-467``) and for the CSR sampler, which draws per batch
position (``:470-487``).

Under a mesh (``build_scan_epoch_fns(mesh=)``) every rank draws the whole
epoch from the seed as one device does, through the same shuffle and
sampler draws, and trains on its ``data`` slice of each step's rows
(a step that does not divide the axis padded with mask-0 rows), through the
generic epoch: the fused kernels are off under a mesh, as in JAX
(``_fused_epoch_config``).  Each slice's loss is scaled to its share of the
step's mask sum, so the shares sum over ``data`` to the single-device
loss (the losses normalize by ``clamp(mask.sum(), 1)``; a custom loss is
assumed to be a weighted mean over its rows), and ``train_step``'s mesh
form (``_mesh_grads``) makes the update the global step's on every rank:
the tables read by id reach ``calculate_loss`` as
``parallel.embedding.ShardedTable`` objects and their gradients are
exchanged over ``data`` by ``TableGrads``; the other leaves' gradients are
summed over ``data`` in one all-reduce.  Drawing the epoch on every rank
costs each the whole sampler pass (JAX feeds each process its shard of the
flat arrays instead, ``:243-265``).  Collie_tpu's slot-domain epoch crashes
under a mesh when the grouped slot count does not divide the data axis
(``:425``); here the epoch is drawn whole and only the steps' rows are
split, so any count trains.

Randomness: per epoch one generator stream (seeded from the trainer's seed
and the epoch) gives the four Feistel keys, then the sampler's draws:
``[N_g, K + 2 * dedup_rounds]`` uniforms for the bucketed sampler, ``[1 +
dedup_rounds, S * B, K]`` (one block per round) for the CSR sampler,
``[S * B, K]`` item ids for approximate sampling (an explicit
epoch draws the keys alone).  It
cannot reproduce JAX's threefry draws; ``draw_epoch`` is the one place the
draws are made, so a test can hand it JAX's keys and uniforms instead.
"""
import collections
import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from collie_tpu_torch.data import ExplicitInteractions, Interactions, InteractionsDataLoader
from collie_tpu_torch.ops.device_sampling import (
    SPARES_PER_ROUND, build_bucketed_complement_tables_torch, build_complement_tables,
    complement_sample_negatives_bucketed, complement_sample_negatives_bucketed_grouped,
    complement_sample_negatives_impl, csr_keys, plan_bucketed_complement_tables)
from collie_tpu_torch.ops.kernels.fused_mf_epoch import (MAX_DIM, _lr_value, fused_mf_epoch,
                                                         fused_mf_explicit_epoch)
from collie_tpu_torch.ops.shuffle import draw_feistel_keys, feistel_permutation_from_keys
from collie_tpu_torch.training.optimizers import state_from_leaves, state_leaves, with_lr
from collie_tpu_torch.training.profiler import annotate
from collie_tpu_torch.training.schedulers import scheduler_device_step

#: the default sampler table budget (``COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB``)
_PADDED_SAMPLER_BUDGET_MB = 1024
_KERNEL_LOSSES = {'hinge': ('hinge', False), 'adaptive_hinge': ('hinge', True),
                  'bpr': ('bpr', False), 'adaptive_bpr': ('bpr', True),
                  'warp': ('warp', False)}
_EXPLICIT_KERNEL_LOSSES = {'mse': ('mse', False), 'mae': ('mae', False)}


def _fused_epoch_config(model, specs, active, loader, mesh=None) -> Optional[dict]:
    """Whether this (model, loader, optimizer) combination trains through
    a fused kernel; returns its config dict or None.  The envelope is the
    JAX engine's (``scan_engine.py:50-156``) without the VMEM budget, plus
    the CUDA kernels' own limit: ``embedding_dim <= MAX_DIM`` (256).

    Explicit data (MSE/MAE, ``y_range`` allowed, no metadata) takes the
    explicit kernel.  The JAX auto gate retires that kernel for TPU reasons
    (``scan_engine.py:97-108``): it "gathers" through one-hot MXU matmuls
    with no K-negative block to amortize them, and overflows scoped VMEM at
    B >= 1024.  Hopper gathers and scatters natively and has no VMEM, so the
    port takes it on ``cuda`` inside the envelope, as for implicit data; the
    two engines compute the same function (``tests/test_fused_epoch.py:
    244-276``)."""
    if mesh is not None or not all(active):
        return None
    from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
    if type(model) is not MatrixFactorizationModel:
        return None
    explicit = isinstance(loader.interactions, ExplicitInteractions)
    hp = model.hparams
    if hp.get('dropout_p', 0.0):
        return None
    if not explicit and hp.get('y_range') is not None:
        return None
    meta_names = ()
    if model.metadata_for_loss:
        weights = model.metadata_for_loss_weights
        if explicit:
            return None
        if not weights or set(weights) != set(model.metadata_for_loss):
            return None
        if sum(weights.values()) > 1:
            return None
        for arr in model.metadata_for_loss.values():
            arr = np.asarray(arr)
            if arr.ndim != 1 or arr.shape[0] != hp['num_items'] \
                    or not np.issubdtype(arr.dtype, np.integer):
                return None
        meta_names = tuple(sorted(model.metadata_for_loss))
    kernel_losses = _EXPLICIT_KERNEL_LOSSES if explicit else _KERNEL_LOSSES
    if model.loss_function not in kernel_losses:
        return None
    loss_kind, adaptive = kernel_losses[model.loss_function]
    # the default dual layout: adam over both embedding tables, sgd biases
    if hp.get('optimizer') not in ('adam', 'sparse_adam'):
        return None
    bias_opt = hp.get('bias_optimizer')
    if bias_opt == 'infer':
        bias_opt = hp.get('optimizer')
    if bias_opt != 'sgd' or len(specs) != 2:
        return None
    by_keys = {tuple(spec.keys): i for i, spec in enumerate(specs)}
    emb_idx = by_keys.get(('item_embeddings', 'user_embeddings'))
    bias_idx = by_keys.get(('item_biases', 'user_biases'))
    if emb_idx is None or bias_idx is None:
        return None
    if any(v.dtype != torch.float32 for v in model.params.values()):
        return None
    if hp['embedding_dim'] > MAX_DIM:
        return None
    wd = float(hp.get('weight_decay', 0.0) or 0.0)
    wd_emb = 0.0 if hp.get('optimizer') == 'sparse_adam' else wd
    y_range = hp.get('y_range')
    return {'adaptive': adaptive, 'loss_kind': loss_kind, 'explicit': explicit,
            'y_range': tuple(y_range) if y_range is not None else None,
            'meta_names': meta_names, 'wd_emb': wd_emb, 'wd_bias': wd,
            'emb_idx': emb_idx, 'bias_idx': bias_idx}


def select_sampler(bucketed_bytes: int) -> str:
    """The exact sampler an epoch takes, ``'bucketed'`` or ``'csr'``, from
    its bucketed tables' size (``BucketedPlan.table_bytes``):
    ``COLLIE_TPU_SAMPLER=bucketed`` takes the bucketed tables, ``auto`` (the
    default) takes them when they fit ``COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB``,
    and any other value, ``padded`` included, the CSR sampler (the module
    docstring says why)."""
    budget = float(os.environ.get('COLLIE_TPU_PADDED_SAMPLER_BUDGET_MB',
                                  _PADDED_SAMPLER_BUDGET_MB)) * 2 ** 20
    kind = os.environ.get('COLLIE_TPU_SAMPLER', 'auto')
    if kind == 'bucketed' or (kind == 'auto' and bucketed_bytes <= budget):
        return 'bucketed'
    return 'csr'


def loader_is_scannable(loader) -> bool:
    """True when the loader's epoch can be materialized as device tensors."""
    return (isinstance(loader, InteractionsDataLoader)
            and isinstance(loader.interactions, (ExplicitInteractions, Interactions)))


def draw_epoch(seed: int, epoch_idx: int, training: bool, device,
               perm_n: Optional[int], sample_shape: Optional[Tuple[int, int]],
               num_items: int, exact: bool
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One epoch's randomness from one generator stream, seeded from
    ``(seed, epoch, training)``: the four Feistel keys (when ``perm_n`` is
    set), then the sampler's draws of
    ``sample_shape`` — float32 uniforms for exact sampling (a leading axis
    of draw rounds for the CSR sampler), item ids in
    ``[0, num_items)`` for approximate sampling."""
    generator = torch.Generator(device=device)
    generator.manual_seed((int(seed) * 1_000_003 + int(epoch_idx) * 2 + int(training))
                          % (2 ** 63))
    keys = draw_feistel_keys(generator) if perm_n else None
    samples = None
    if sample_shape is not None:
        if exact:
            samples = torch.rand(sample_shape, generator=generator, device=device)
        else:
            samples = torch.randint(0, num_items, sample_shape, generator=generator,
                                    device=device, dtype=torch.int32)
    return keys, samples


def dropout_step_seeds(seed: int, epoch_idx: int, num_steps: int,
                       data_index: int = 0) -> List[int]:
    """One dropout seed per step of a generic training epoch, derived from
    ``(seed, epoch)`` and the step index: the analog of the JAX engine's
    ``fold_in(dropout_rng, step_i)`` (``collie_tpu/training/scan_engine.py:636-644``).
    Under a mesh each ``data`` rank draws the masks of its own rows: rank
    ``data_index`` > 0 mixes its index in (rank 0 keeps the single-device
    seeds), and the ``model`` ranks of one ``data`` slice share them."""
    entropy = [int(seed), int(epoch_idx), 3] + ([int(data_index)] if data_index else [])
    words = np.random.SeedSequence(entropy).generate_state(num_steps, dtype=np.uint64)
    return [int(w) for w in words]


def select_state(live: torch.Tensor, new: Any, old: Any) -> Any:
    """An optimizer state, ``new`` where ``live`` and ``old`` elsewhere:
    one ``torch.where`` per tensor leaf; a leaf that is not a tensor (a
    custom state's host value) is ``new``'s."""
    pairs = zip(state_leaves(new), state_leaves(old))
    return state_from_leaves(new, iter([
        torch.where(live, a, b) if torch.is_tensor(a) and torch.is_tensor(b) else a
        for a, b in pairs]))


def table_layout(model, mesh, name: str, value: torch.Tensor) -> Optional[bool]:
    """How a mesh step holds the leaf ``name`` (this rank's ``value``):
    True for a row shard of a table read by id, False for such a table
    held whole, None for any other leaf (``parallel.sharding.is_id_table``;
    a fused table is split as its named parts are)."""
    from collie_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size
    from collie_tpu_torch.parallel.sharding import table_rows

    rows = table_rows(name, model.hparams)
    if rows is None or not value.dim():
        return None
    n_model = axis_size(mesh, MODEL_AXIS)
    if n_model > 1 and rows % n_model == 0 and value.shape[0] == rows // n_model:
        return True
    return False if value.shape[0] == rows else None


def mesh_leaves(model, mesh, params: Dict[str, torch.Tensor], differentiated=(), tape=None
                ) -> Dict[str, Any]:
    """The params a mesh step hands ``calculate_loss``: each table read by
    id as a ``ShardedTable`` (recording on ``tape`` when differentiated),
    the other leaves as tensors (requiring grad when differentiated)."""
    from collie_tpu_torch.parallel.embedding import ShardedTable

    leaves = {}
    for k, v in params.items():
        sharded = table_layout(model, mesh, k, v)
        if sharded is not None:
            leaves[k] = ShardedTable(v, mesh, sharded, tape if k in differentiated else None, k)
        else:
            leaves[k] = v.detach().requires_grad_() if k in differentiated else v.detach()
    return leaves


def _mesh_grads(model, mesh, params, differentiated, batch, generator, loss_scale):
    """A mesh step's loss and gradients (``build_scan_epoch_fns``): the loss
    of this rank's rows times ``loss_scale``, each dense leaf's gradient
    summed over ``data`` (one all-reduce for all of them), each table's
    from ``TableGrads``' exchange."""
    from collie_tpu_torch.parallel.distributed import all_reduce_sum
    from collie_tpu_torch.parallel.embedding import TableGrads
    from collie_tpu_torch.parallel.mesh import DATA_AXIS

    tape = TableGrads(mesh)
    leaves = mesh_leaves(model, mesh, params, differentiated, tape)
    dense = [k for k in differentiated if torch.is_tensor(leaves[k])]
    loss = model.calculate_loss(leaves, batch, generator=generator, training=True) * loss_scale
    rows = tape.row_leaves()
    got = torch.autograd.grad(loss, [leaves[k] for k in dense] + rows, allow_unused=True)
    grads = {k: g for k, g in zip(dense, got) if g is not None}
    if grads:
        flat = all_reduce_sum(torch.cat([g.float().reshape(-1) for g in grads.values()]), mesh,
                              DATA_AXIS)
        offsets = np.cumsum([0] + [g.numel() for g in grads.values()])
        grads = {k: flat[a:b].reshape(g.shape).to(g.dtype)
                 for (k, g), a, b in zip(grads.items(), offsets, offsets[1:])}
    grads.update(tape.table_gradients(got[len(dense):], params))
    return loss, grads


def train_step(model, specs, active: List[bool], params: Dict[str, torch.Tensor],
               opt_states: tuple, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None, fused_tables: bool = False,
               mesh=None, loss_scale=None):
    """One optimizer step on one batch: ``calculate_loss`` under autograd,
    then each active optimizer's update of its params (the JAX package's
    ``train_step``, ``collie_tpu/training/trainer.py:960-972``).  Returns
    ``(params, opt_states, loss)``; ``generator`` feeds dropout.

    ``fused_tables``: ``params`` hold the model's fused tables
    (``model.fuse_params``), as the generic epoch carries them
    (``collie_tpu/training/scan_engine.py:613-670``).  Autograd runs against
    the fused tables of which a part is trained; their gradients are split
    into the named keys, each active optimizer updates its named slices
    with the same transforms and states as on the named layout, and the
    tables are fused again.

    ``mesh``: ``params`` are this rank's shards and ``batch`` its ``data``
    slice of the step's rows; the returned loss is this slice's share of
    the step's loss (``loss_scale`` times its loss), which sums over
    ``data`` to the step's loss (``build_scan_epoch_fns``), and the update
    is the global step's on every rank (``_mesh_grads``)."""
    trained = [k for spec, on in zip(specs, active) if on for k in spec.keys]
    differentiated = trained
    if fused_tables:
        parts = {fused_key: {a, b} for a, b, fused_key in model._FUSED_TABLE_SPEC}
        differentiated = [k for k in params if k in trained or parts.get(k, set()) & set(trained)]
    if mesh is not None:
        loss, grads = _mesh_grads(model, mesh, params, differentiated, batch, generator,
                                  loss_scale)
    else:
        leaves = {k: (v.detach().requires_grad_() if k in differentiated else v.detach())
                  for k, v in params.items()}
        loss = model.calculate_loss(leaves, batch, generator=generator, training=True)
        grads = dict(zip(differentiated, torch.autograd.grad(
            loss, [leaves[k] for k in differentiated], allow_unused=True)))
    if fused_tables:
        params = model.unfuse_params(params)
        grads = model.unfuse_params({k: g for k, g in grads.items() if g is not None})
    states = list(opt_states)
    with torch.no_grad():
        for i, spec in enumerate(specs):
            if not active[i]:
                continue
            sub_params = {k: params[k] for k in spec.keys}
            sub_grads = {k: (grads[k] if grads.get(k) is not None else torch.zeros_like(params[k]))
                         for k in spec.keys}
            updates, states[i] = spec.transform.update(sub_grads, states[i], sub_params)
            params = {**params, **{k: sub_params[k] + updates[k] for k in spec.keys}}
        if fused_tables:
            params = model.fuse_params(params)
    return params, tuple(states), loss.detach()


def train_steps(model, specs, active: List[bool], params: Dict[str, torch.Tensor],
                opt_states: tuple, batches: Dict[str, torch.Tensor],
                step_seeds: Optional[List[int]], fused_tables: bool, mesh=None,
                loss_scales: Optional[torch.Tensor] = None):
    """``train_step`` over every step of ``batches`` (``[S, ...]`` tensors),
    step ``s`` with a dropout generator seeded ``step_seeds[s]`` (None: no
    dropout), the tables carried fused when ``fused_tables``; under a
    ``mesh`` with ``loss_scales[s]``; each step is a ``collie.fit.step``
    span.  Returns ``(params, opt_states, per-step losses)``, the params
    named and contiguous again; an untrained table keeps its tensor, so
    checkpoints, saves and a live select see the named layout only."""
    old_params = params
    if fused_tables:
        params = model.fuse_params(params)
    losses = []
    for s in range(next(iter(batches.values())).shape[0]):
        generator = None
        if step_seeds is not None:
            generator = torch.Generator(device=model.device)
            generator.manual_seed(step_seeds[s])
        with annotate('collie.fit.step'):
            params, opt_states, loss = train_step(
                model, specs, active, params, opt_states, {k: v[s] for k, v in batches.items()},
                generator, fused_tables, mesh, None if loss_scales is None else loss_scales[s])
        losses.append(loss)
    if fused_tables:
        trained = {k for spec, on in zip(specs, active) if on for k in spec.keys}
        params = {k: (v.contiguous() if k in trained else old_params[k])
                  for k, v in model.unfuse_params(params).items()}
    return params, opt_states, losses


def device_stamp(device: torch.device):
    """A point in time on ``device``'s timeline: a recorded CUDA event on the
    card (no sync), the host clock elsewhere."""
    if device.type == 'cuda':
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        return mark
    return time.perf_counter()


def stamps_ms(marks: Sequence[Any]) -> List[float]:
    """Milliseconds between consecutive ``device_stamp`` marks (reading CUDA
    events waits for the last one)."""
    if marks and not isinstance(marks[0], float):
        with annotate('collie.sync'):
            marks[-1].synchronize()
        return [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    return [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]


class _EpochClock:
    """Where an epoch's time goes: the shuffle, the sampler (with the batch
    assembly) and training, from four ``device_stamp`` marks an epoch (the
    start, after the shuffle, after the sampler, the end).  The last
    ``KEEP`` epochs' marks are kept, so a whole fit reads a flight's splits
    after the flight's one sync."""
    KEEP = 64

    def __init__(self, device: torch.device):
        self.device = device
        self.open: Optional[List] = None
        self.epochs = collections.deque(maxlen=self.KEEP)

    def begin(self) -> None:
        self.open = [device_stamp(self.device)]

    def mark(self) -> None:
        """The next mark of the open epoch (none open: ignored, as for an
        ``epoch_batches`` call outside an epoch)."""
        if self.open is None:
            return
        self.open.append(device_stamp(self.device))
        if len(self.open) == 4:
            self.epochs.append(self.open)
            self.open = None

    def split_ms(self, epochs: Optional[int] = None):
        """``shuffle_ms``, ``sample_ms`` and ``train_ms`` of the last epoch,
        or a list of them for each of the last ``epochs`` epochs, oldest
        first."""
        chosen = list(self.epochs)[-(epochs or 1):]
        splits = [dict(zip(('shuffle_ms', 'sample_ms', 'train_ms'), stamps_ms(marks)))
                  for marks in chosen]
        return splits if epochs is not None else splits[-1]


def build_scan_epoch_fns(model, specs, active: List[bool], loader, shuffle: bool,
                         mesh=None, training: bool = True, dedup_rounds: int = 1,
                         fused: Optional[bool] = None) -> Tuple[Callable, dict, int, int]:
    """Build an epoch function over ``loader``'s data.

    Returns ``(epoch_fn, data, num_steps, num_examples)``.  For
    ``training=True``: ``epoch_fn(params, opt_states, data, seed, epoch_idx,
    live=None) -> (params, opt_states, mean_loss)``, with
    ``epoch_fn.epoch_batches(seed, epoch_idx)`` (the epoch's batches),
    ``epoch_fn.split_ms(epochs=None)`` (shuffle, sampler and train
    milliseconds of the last epoch, or a list for the last ``epochs``),
    ``epoch_fn.fused`` and ``epoch_fn.sampler`` (``select_sampler``'s
    choice, None without exact sampling); for validation:
    ``epoch_fn(params, data, seed, epoch_idx) -> mean_loss``.  ``mean_loss``
    is a 0-d tensor on the model's device; ``live``: see the module
    docstring.  ``fused``: ``None`` (the trainer's) follows
    ``COLLIE_TPU_FUSED_EPOCH``, by default the kernel on ``cuda`` inside the
    envelope and the generic epoch elsewhere; ``True`` requires the envelope
    and runs the fused function on any device (its plain version on the
    CPU); ``False`` runs the generic autograd epoch on any device.

    ``mesh``: the epoch trains on the mesh (module docstring) through the
    generic epoch on every rank, the fused kernels off as in JAX
    (``_fused_epoch_config``); ``params`` and ``opt_states`` are then this
    rank's shards, and the loss the global one on every rank."""
    inter = loader.interactions
    explicit = isinstance(inter, ExplicitInteractions)
    device = model.device
    n = inter.num_interactions
    B = loader.batch_size
    if getattr(loader, 'drop_last', False):
        S = n // B
        n_used = S * B
    else:
        S = -(-n // B)
        n_used = n
    pad = S * B - n_used
    slot_tail = 0
    num_items = inter.num_items
    # explicit data has no negatives (``num_negative_samples`` raises there)
    K = 0 if explicit else inter.num_negative_samples
    exact = not explicit and inter.exact_negative_sampling
    slot_epoch = os.environ.get('COLLIE_TPU_SLOT_EPOCH', '1') != '0'

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    item_bits = max(int(num_items - 1).bit_length(), 1)
    packable = ((inter.num_users - 1) << item_bits | (num_items - 1)) < 2 ** 31
    data: Dict = {'mask_flat': put(np.concatenate([np.ones(n_used, dtype=np.float32),
                                                   np.zeros(pad, dtype=np.float32)]))}
    if packable:
        data['packed'] = put((inter.mat.row.astype(np.int64) << item_bits
                              | inter.mat.col.astype(np.int64)).astype(np.int32))
    else:
        data['rows'] = put(inter.mat.row.astype(np.int32))
        data['cols'] = put(inter.mat.col.astype(np.int32))
    if explicit:
        data['ratings'] = put(inter.mat.data.astype(np.float32))
    N_g = 0
    sampler = None
    item_mask = (1 << item_bits) - 1
    # the sampler's choice and its complement tables: the bucketed ones built
    # on the device from the ids uploaded above, the CSR ones on the host
    with annotate('collie.fit.sampler_tables'):
        if exact:
            if packable:
                ids = (data['packed'] >> item_bits, data['packed'] & item_mask)
            else:
                ids = (data['rows'], data['cols'])
            plan = plan_bucketed_complement_tables(*ids, *inter.mat.shape)
            sampler = select_sampler(plan.table_bytes)
        if sampler == 'bucketed':
            (data['bucket_specs'], data['row_counts'], data['users_g'],
             pos_of) = build_bucketed_complement_tables_torch(
                *ids, *inter.mat.shape, plan=plan)
            N_g = data['users_g'].shape[0]
            drop_last = getattr(loader, 'drop_last', False)
            if packable and shuffle and not drop_last and N_g >= 2 and (N_g - n) <= 0.02 * n \
                    and slot_epoch:
                # slot-domain epoch: ids and a validity bit at grouped-slot
                # positions (bucket-pad slots -> mask 0), one row gather per
                # epoch.  Its steps cover every slot, so a loader that drops
                # its last partial batch takes the reorder path, which truncates
                # the epoch to whole batches
                slots = pos_of.long()
                data['packed_slots'] = data['packed'].new_zeros(N_g).index_put_(
                    (slots,), data['packed'])
                data['slot_mask'] = torch.zeros(N_g, dtype=torch.int32,
                                                device=device).index_fill_(0, slots, 1)
                del data['packed'], data['mask_flat']
                S = -(-N_g // B)
                slot_tail = S * B - N_g
            else:
                data['pos_of'] = pos_of
        elif sampler == 'csr':
            indptr_np, shifted_np = build_complement_tables(inter.mat)
            data['indptr'] = put(indptr_np)
            data['shifted_cols'] = put(shifted_np)
            data['csr_keys'] = csr_keys(data['indptr'], data['shifted_cols'])
    W = K + SPARES_PER_ROUND * dedup_rounds
    clock = _EpochClock(device)
    data_index = 0
    if mesh is not None:
        from collie_tpu_torch.parallel.distributed import all_reduce_sum
        from collie_tpu_torch.parallel.mesh import DATA_AXIS, axis_index
        from collie_tpu_torch.parallel.sharding import data_slice

        data_index = axis_index(mesh, DATA_AXIS)
        row0, b_local = data_slice(B, mesh)

    def _local(batches):
        """This rank's ``data`` slice of every step's rows, the steps padded
        with rows of id 0 and mask 0 to a multiple of the axis, and each
        step's loss scale: its slice's share of the step's mask sum, as the
        losses normalize (``clamp(mask.sum(), 1)``), so the slices' scaled
        losses sum to the single-device step's loss."""
        out = {}
        for key, value in batches.items():
            extra = row0 + b_local - value.shape[1]
            if extra > 0:
                value = torch.cat([value, value.new_zeros((S, extra) + value.shape[2:])], dim=1)
            out[key] = value[:, row0:row0 + b_local]
        scales = (out['mask'].sum(dim=1).clamp(min=1.0)
                  / batches['mask'].sum(dim=1).clamp(min=1.0))
        return out, scales

    def _global_mean(losses):
        """The epoch's mean of the steps' losses: the slices' shares summed
        over ``data`` (one all-reduce an epoch), the same on every rank."""
        losses = torch.stack(losses)
        if mesh is not None:
            losses = all_reduce_sum(losses, mesh, DATA_AXIS).to(device)
        return losses.mean()

    def _draws(seed, epoch_idx):
        if 'packed_slots' in data:
            return draw_epoch(seed, epoch_idx, training, device, S * B - slot_tail,
                              (S * B - slot_tail, W), num_items, True)
        perm_n = n if shuffle and n >= 2 else None
        if explicit:
            shape = None
        elif sampler == 'bucketed':
            shape = (N_g, W)
        elif exact:
            shape = (1 + dedup_rounds, S * B, K)   # one block per draw round
        else:
            shape = (S * B, K)
        return draw_epoch(seed, epoch_idx, training, device, perm_n, shape, num_items, exact)

    def _epoch_batches(seed, epoch_idx) -> Dict[str, torch.Tensor]:
        """The whole epoch on the device: ``users``/``pos_items`` ``[S, B]``
        int32, ``neg_items [S, B, K]`` int32 (in the item range), ``mask
        [S, B]`` float32; for explicit data ``users``/``items [S, B]`` int32
        and ``ratings``/``mask [S, B]`` float32."""
        keys, samples = _draws(seed, epoch_idx)
        if 'packed_slots' in data:
            n_slots = S * B - slot_tail
            sigma = feistel_permutation_from_keys(keys, n_slots)
            sidx = torch.cat([sigma, sigma[:1].repeat(slot_tail)]) if slot_tail else sigma
            clock.mark()
            negs_g = complement_sample_negatives_bucketed_grouped(
                samples, data['users_g'], data['bucket_specs'], data['row_counts'],
                num_items, K, dedup_rounds=dedup_rounds)
            combined = torch.cat([data['packed_slots'][:, None], data['slot_mask'][:, None],
                                  negs_g], dim=1)
            rows = combined[sidx]                # the ONE random gather
            if slot_tail:
                rows[n_slots:, 1] = 0            # tail positions repeat slot sigma[0]
            rows = rows.reshape(S, B, 2 + K)
            pk = rows[..., 0]
            return {
                'users': pk >> item_bits,
                'pos_items': pk & item_mask,
                'mask': rows[..., 1].to(torch.float32),
                # bucket-pad slots drew against another user's row, so their
                # ids can reach [num_items, num_items + deg): clamp before
                # any gather
                'neg_items': torch.clamp(rows[..., 2:], max=num_items - 1).contiguous(),
            }
        if keys is not None:
            perm = feistel_permutation_from_keys(keys, n)[:n_used]
        else:
            perm = torch.arange(n_used, device=device)
        idx = torch.cat([perm, perm[:1].repeat(pad)]) if pad else perm
        clock.mark()
        if 'packed' in data:
            pk = data['packed'][idx]
            users_flat, cols_flat = pk >> item_bits, pk & item_mask
        else:
            users_flat, cols_flat = data['rows'][idx], data['cols'][idx]
        if explicit:
            return {'users': users_flat.reshape(S, B),
                    'items': cols_flat.reshape(S, B),
                    'ratings': data['ratings'][idx].reshape(S, B),
                    'mask': data['mask_flat'].reshape(S, B)}
        if sampler == 'bucketed':
            negs = complement_sample_negatives_bucketed(
                samples, idx, data['pos_of'], data['users_g'], data['bucket_specs'],
                data['row_counts'], num_items, K, dedup_rounds=dedup_rounds)
            # a user holding every item draws the sentinel ``num_items``
            # that ends its table row: clamp before any gather
            negs = torch.clamp(negs, max=num_items - 1)
        elif sampler == 'csr':
            negs = complement_sample_negatives_impl(
                samples, users_flat, data['indptr'], data['shifted_cols'], num_items, K,
                dedup_rounds=dedup_rounds, keys=data['csr_keys'])
            # a user holding every item draws -1: clamp before any gather
            negs = torch.clamp(negs, 0, num_items - 1)
        else:
            negs = samples
        return {'users': users_flat.reshape(S, B),
                'pos_items': cols_flat.reshape(S, B),
                'mask': data['mask_flat'].reshape(S, B),
                'neg_items': negs.reshape(S, B, K).contiguous()}

    if not training:
        def val_epoch_fn(params, data_, seed, epoch_idx):
            batches = _epoch_batches(seed, epoch_idx)
            if mesh is not None:
                batches, scales = _local(batches)
                params = mesh_leaves(model, mesh, params)
            with torch.no_grad():
                losses = [model.calculate_loss(params, {k: v[s] for k, v in batches.items()},
                                               training=False) for s in range(S)]
            if mesh is not None:
                losses = [loss * scales[s] for s, loss in enumerate(losses)]
            return _global_mean(losses)

        val_epoch_fn.sampler = sampler
        return val_epoch_fn, data, S, n_used

    gate = os.environ.get('COLLIE_TPU_FUSED_EPOCH', 'auto') if fused is None else None
    cfg = (None if fused is False or gate == '0'
           else _fused_epoch_config(model, specs, active, loader, mesh))
    if fused and cfg is None:
        raise ValueError('fused=True but this model is outside the kernel\'s envelope')
    use_fused = cfg is not None and (fused or gate == '1' or device.type == 'cuda')
    fused_tables = (not use_fused and os.environ.get('COLLIE_TPU_FUSED_TABLES', 'auto') != '0'
                    and model.supports_fused_tables())

    def fused_states(opt_states, cnt, mu_u, nu_u, mu_i, nu_i, live):
        """The optimizer states after a fused epoch: the Adam moments and
        count it returns; both ``inject_hyperparams`` counts advance by S
        (by 0 in a skipped epoch)."""
        emb_idx, bias_idx = cfg['emb_idx'], cfg['bias_idx']
        emb_state, bias_state = opt_states[emb_idx], opt_states[bias_idx]
        steps = S if live is None else S * live.to(torch.int32)
        new_states = list(opt_states)
        new_states[emb_idx] = dataclasses.replace(
            emb_state, count=emb_state.count + steps, adam_count=cnt,
            mu={'item_embeddings': mu_i, 'user_embeddings': mu_u},
            nu={'item_embeddings': nu_i, 'user_embeddings': nu_u})
        new_states[bias_idx] = dataclasses.replace(bias_state, count=bias_state.count + steps)
        return tuple(new_states)

    if use_fused and cfg['explicit']:
        def epoch_fn(params, opt_states, data_, seed, epoch_idx, live=None):
            clock.begin()
            batches = _epoch_batches(seed, epoch_idx)
            clock.mark()
            emb_state = opt_states[cfg['emb_idx']]
            # the kernel steps the user biases too: pointwise losses give
            # them a gradient, so there is no closed-form decay here
            (ue, ie, ub, ib, mu_u, nu_u, mu_i, nu_i, cnt, losses) = fused_mf_explicit_epoch(
                params['user_embeddings'], params['item_embeddings'],
                params['user_biases'], params['item_biases'],
                emb_state.mu['user_embeddings'], emb_state.nu['user_embeddings'],
                emb_state.mu['item_embeddings'], emb_state.nu['item_embeddings'],
                emb_state.adam_count,
                batches['users'], batches['items'], batches['ratings'], batches['mask'],
                emb_state.learning_rate, opt_states[cfg['bias_idx']].learning_rate,
                loss_kind=cfg['loss_kind'], y_range=cfg['y_range'],
                wd_emb=cfg['wd_emb'], wd_bias=cfg['wd_bias'], live=live)
            new_params = {**params, 'user_embeddings': ue, 'item_embeddings': ie,
                          'user_biases': ub, 'item_biases': ib}
            clock.mark()
            return (new_params, fused_states(opt_states, cnt, mu_u, nu_u, mu_i, nu_i, live),
                    losses.mean())
    elif use_fused:
        emb_idx, bias_idx = cfg['emb_idx'], cfg['bias_idx']
        meta_rows = (torch.stack([torch.as_tensor(np.asarray(model.metadata_for_loss[m]),
                                                  device=device).to(torch.int32)
                                  for m in cfg['meta_names']])
                     if cfg['meta_names'] else None)
        meta_weights = tuple(float(model.metadata_for_loss_weights[m])
                             for m in cfg['meta_names'])

        def epoch_fn(params, opt_states, data_, seed, epoch_idx, live=None):
            clock.begin()
            batches = _epoch_batches(seed, epoch_idx)
            clock.mark()
            emb_state, bias_state = opt_states[emb_idx], opt_states[bias_idx]
            lr_b = bias_state.learning_rate
            (ue, ie, ib, mu_u, nu_u, mu_i, nu_i, cnt, losses) = fused_mf_epoch(
                params['user_embeddings'], params['item_embeddings'], params['item_biases'],
                emb_state.mu['user_embeddings'], emb_state.nu['user_embeddings'],
                emb_state.mu['item_embeddings'], emb_state.nu['item_embeddings'],
                emb_state.adam_count,
                batches['users'], batches['pos_items'], batches['neg_items'],
                batches['mask'], emb_state.learning_rate, lr_b, meta_rows,
                K=K, adaptive=cfg['adaptive'], loss_kind=cfg['loss_kind'],
                meta_weights=meta_weights, wd_emb=cfg['wd_emb'], wd_bias=cfg['wd_bias'],
                live=live)
            new_params = {**params, 'user_embeddings': ue, 'item_embeddings': ie,
                          'item_biases': ib}
            if cfg['wd_bias']:
                # user biases get zero data gradient from pairwise ranking
                # losses: their sgd + coupled decay is b *= (1 - lr*wd) per step
                rate = _lr_value(lr_b, device) * cfg['wd_bias']
                decay = (1.0 - rate) ** S
                if live is not None:
                    decay = torch.where(live, decay, torch.ones_like(decay))
                new_params['user_biases'] = params['user_biases'] * decay
            clock.mark()
            return (new_params, fused_states(opt_states, cnt, mu_u, nu_u, mu_i, nu_i, live),
                    losses.mean())
    else:
        with_dropout = not model._score_is_deterministic()

        def epoch_fn(params, opt_states, data_, seed, epoch_idx, live=None):
            clock.begin()
            old_params, old_states = params, opt_states
            batches = _epoch_batches(seed, epoch_idx)
            scales = None
            if mesh is not None:
                batches, scales = _local(batches)
            clock.mark()
            step_seeds = (dropout_step_seeds(seed, epoch_idx, S, data_index) if with_dropout
                          else None)
            params, opt_states, losses = train_steps(model, specs, active, params, opt_states,
                                                     batches, step_seeds, fused_tables, mesh,
                                                     scales)
            loss = _global_mean(losses)
            if live is not None:
                params = {k: v if v is old_params[k] else torch.where(live, v, old_params[k])
                          for k, v in params.items()}
                opt_states = tuple(select_state(live, new, old)
                                   for new, old in zip(opt_states, old_states))
                loss = torch.where(live, loss, torch.full_like(loss, float('nan')))
            clock.mark()
            return params, opt_states, loss

    epoch_fn.split_ms = clock.split_ms
    epoch_fn.fused = use_fused
    epoch_fn.fused_tables = fused_tables
    epoch_fn.sampler = sampler
    epoch_fn.epoch_batches = _epoch_batches
    return epoch_fn, data, S, n_used



def hdf5_chunk_plan(total_steps: int, max_chunk_steps: int) -> List[Tuple[int, int]]:
    """An out-of-core epoch as ``(start_step, num_steps)`` chunks
    (``collie_tpu/training/scan_engine.py:691``): full chunks of
    ``max_chunk_steps``, then the tail in power-of-two chunks, so only the
    last batch of the last chunk can be partly padding and no step is all
    padding (such a step would still decay the Adam moments, where the
    per-step path never runs it)."""
    plan = []
    done = 0
    while done < total_steps:
        b = max_chunk_steps
        while b > total_steps - done:
            b //= 2
        plan.append((done, b))
        done += b
    return plan


def draw_chunk(seed: int, epoch_idx: int, chunk_idx: int, device, perm_n: Optional[int],
               neg_shape: Tuple[int, int], num_items: int, num_steps: int, dropout: bool
               ) -> Tuple[Optional[torch.Tensor], torch.Tensor, Optional[List[int]]]:
    """One out-of-core chunk's randomness, from ``(seed, epoch, chunk)``:
    the four Feistel keys of its in-chunk shuffle (when ``perm_n`` is set),
    its approximate negatives ``neg_shape = [C, K]`` int32 in
    ``[0, num_items)`` drawn on ``device``, and one dropout seed a step
    (when ``dropout``).  The analog of the JAX chunk's
    ``fold_in(fold_in(base_rng, epoch), chunk)`` split three ways
    (``collie_tpu/training/scan_engine.py:736-739``); the one place a chunk
    draws, so a test can hand it JAX's keys and negatives."""
    words = np.random.SeedSequence([int(seed), int(epoch_idx), int(chunk_idx), 6]) \
        .generate_state(1 + num_steps, dtype=np.uint64)
    generator = torch.Generator(device=device)
    generator.manual_seed(int(words[0]) % (2 ** 63))
    keys = draw_feistel_keys(generator) if perm_n else None
    negs = torch.randint(0, num_items, neg_shape, generator=generator, device=device,
                         dtype=torch.int32)
    step_seeds = [int(w) for w in words[1:]] if dropout else None
    return keys, negs, step_seeds


def build_hdf5_chunk_make(model, specs, active: List[bool], loader,
                          shuffle: bool) -> Callable[[int], Callable]:
    """The out-of-core chunk tier (``collie_tpu/training/scan_engine.py:713``):
    a factory of chunk functions for an ``HDF5InteractionsDataLoader``.

    ``make(num_steps)`` returns ``chunk_fn(params, opt_states, users, items,
    mask, seed, epoch_idx, chunk_idx) -> (params, opt_states, loss_sum)``
    over flat ``[num_steps * B]`` device tensors (int32 ids, float32 mask):
    the chunk's draws (``draw_chunk``), its in-chunk shuffle (the Feistel
    permutation, on the card the cycle-walk kernel) applied to ids and mask
    together, then one ``train_step`` a batch, on the fused table layout
    where the model has one (``COLLIE_TPU_FUSED_TABLES``, read here as JAX
    reads it at ``:751-754``).  ``loss_sum`` is the 0-d sum of the per-step losses on
    the device; the trainer divides the epoch's total by the real step
    count.  Like JAX's chunk tier it trains through the autodiff step and
    never through ``fused_mf_epoch``, and sampling is approximate, as for
    all HDF5 data.  Nothing in a chunk reads a value back from the card."""
    inter = loader.interactions
    B = loader.batch_size
    K = inter.num_negative_samples
    num_items = inter.num_items
    device = model.device
    fuse_tables = (os.environ.get('COLLIE_TPU_FUSED_TABLES', 'auto') != '0'
                   and model.supports_fused_tables())
    with_dropout = not model._score_is_deterministic()

    def make(num_steps: int) -> Callable:
        C = num_steps * B
        permute = shuffle and C >= 2

        def chunk_fn(params, opt_states, users, items, mask, seed, epoch_idx, chunk_idx):
            keys, negs, step_seeds = draw_chunk(seed, epoch_idx, chunk_idx, device,
                                                C if permute else None, (C, K), num_items,
                                                num_steps, with_dropout)
            if permute:
                perm = feistel_permutation_from_keys(keys, C)
                users, items, mask = users[perm], items[perm], mask[perm]
            batches = {'users': users.reshape(num_steps, B),
                       'pos_items': items.reshape(num_steps, B),
                       'neg_items': negs.reshape(num_steps, B, K),
                       'mask': mask.reshape(num_steps, B)}
            params, opt_states, losses = train_steps(model, specs, active, params, opt_states,
                                                     batches, step_seeds, fuse_tables)
            return params, opt_states, torch.stack(losses).sum()

        return chunk_fn

    return make


def build_scan_fit_fn(train_epoch_fn, val_epoch_fn, *, monitor_val: bool,
                      sched_kinds: Sequence[str], sched_statics: Sequence[tuple],
                      es_patience: Optional[int], terminate_on_nan: bool) -> Callable:
    """A block of a whole fit: epochs back to back with every per-epoch
    decision on the device, ported from ``collie_tpu/training/
    scan_engine.py:815-946``.

    Per epoch: the training epoch under ``live = ~stopped``, the validation
    loss when ``monitor_val``, then the device schedulers
    (``scheduler_device_step``, rewriting each scheduled state's 0-d
    learning-rate tensor), early stopping and the NaN trip.  As in JAX: a
    NaN epoch (the TRAIN loss only, under ``terminate_on_nan``) leaves the
    scheduler and early-stopping state alone and sets ``stopped``; patience
    counts only non-improving epochs, so ``es_patience=0`` never stops an
    improving run; an epoch after a stop changes nothing and reports NaN
    losses.  Nothing waits for the host.

    Returns ``fit_fn(params, opt_states, train_data, val_data, seed,
    epoch_idxs, sched_state, es_state, marks=None) -> (params, opt_states,
    sched_state, es_state, train_losses [b], val_losses [b], lrs, ran [b])``
    with ``lrs`` one ``[b]`` tensor per optimizer (NaN where no scheduler
    acts), ``es_state = (best, n_no_improve, stopped, nan_seen)`` 0-d
    tensors (``best`` and ``n_no_improve`` advance only under a patience,
    the one reader of them), and ``marks`` a list that gets one
    ``device_stamp`` at each epoch's start."""
    def current_lrs(opt_states, nan):
        return [nan if kind == 'none' else opt_states[i].learning_rate
                for i, kind in enumerate(sched_kinds)]

    def fit_fn(params, opt_states, train_data, val_data, seed, epoch_idxs, sched_state,
               es_state, marks: Optional[list] = None):
        device = es_state[2].device
        nan = torch.full((), float('nan'), dtype=torch.float32, device=device)
        outputs = []
        for epoch_idx in epoch_idxs:
            best_es, n_no, stopped, nan_seen = es_state
            if marks is not None:
                marks.append(device_stamp(device))
            live = ~stopped
            params, opt_states, train_loss = train_epoch_fn(
                params, opt_states, train_data, seed, int(epoch_idx), live)
            train_loss = torch.where(live, train_loss, nan)
            if monitor_val:
                val_loss = torch.where(live, val_epoch_fn(params, val_data, seed,
                                                          int(epoch_idx)), nan)
                monitored = val_loss
            else:
                val_loss, monitored = nan, train_loss
            if terminate_on_nan:
                # the per-epoch loop's NaN guard checks the TRAIN loss only
                bad = live & ~torch.isfinite(train_loss)
                hold = stopped | bad            # a skipped or NaN epoch steps nothing
                stopped, nan_seen = hold, nan_seen | bad
            else:
                bad, hold = None, stopped

            new_states, new_sched = list(opt_states), []
            for i, kind in enumerate(sched_kinds):
                if kind == 'none':
                    new_sched.append(sched_state[i])
                    continue
                lr = new_states[i].learning_rate
                stepped, new_lr = scheduler_device_step(kind, sched_statics[i], sched_state[i],
                                                        lr, monitored)
                new_sched.append(tuple(torch.where(hold, old, new)
                                       for new, old in zip(stepped, sched_state[i])))
                new_states[i] = with_lr(new_states[i], torch.where(hold, lr, new_lr))
            opt_states, sched_state = tuple(new_states), tuple(new_sched)

            if es_patience is not None:
                # only patience reads the early-stopping best and count
                improved = monitored < best_es
                best_es = torch.where(hold | ~improved, best_es, monitored)
                n_no = torch.where(hold, n_no, torch.where(improved, 0, n_no + 1))
                # the per-epoch loop checks patience only on NON-improving epochs
                stopped = stopped | (~hold & ~improved & (n_no >= es_patience))
            es_state = (best_es, n_no, stopped, nan_seen)
            outputs.append((train_loss, val_loss, current_lrs(opt_states, nan), live))
        train_losses, val_losses, lrs, ran = zip(*outputs)
        return (params, opt_states, sched_state, es_state, torch.stack(train_losses),
                torch.stack(val_losses), [torch.stack(per) for per in zip(*lrs)],
                torch.stack(ran))

    return fit_fn


def fetch_to_host(tensors: Sequence[torch.Tensor]) -> List[np.ndarray]:
    """Small float32 / int32 / bool device tensors as numpy arrays of their
    dtypes and shapes, through ONE device-to-host copy: the integers travel
    bitcast as float32 words beside the floats."""
    words = []
    for t in tensors:
        t = t.reshape(-1)
        if t.dtype == torch.bool:
            t = t.to(torch.int32)
        words.append(t.view(torch.float32) if t.dtype == torch.int32 else t.to(torch.float32))
    with annotate('collie.sync'):
        host = torch.cat(words).cpu().numpy() if words else np.zeros(0, np.float32)
    out, offset = [], 0
    for t in tensors:
        chunk = host[offset:offset + t.numel()]
        offset += t.numel()
        if t.dtype in (torch.int32, torch.bool):
            chunk = chunk.view(np.int32)
            if t.dtype == torch.bool:
                chunk = chunk != 0
        out.append(chunk.reshape(tuple(t.shape)))
    return out
