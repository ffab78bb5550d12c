"""Whole-epoch training: the epoch is built on the device, then trained.

Port of ``collie_tpu/training/scan_engine.py`` for single-device in-memory
implicit loaders.  Per epoch the interaction ids live on the device; the
engine shuffles them with the Feistel permutation, samples every negative of
the epoch in one pass of the degree-bucketed complement sampler, and then
trains:

* through the fused kernel (``ops/kernels/fused_mf_epoch.py``), one call per
  epoch, when the model is an MF in the kernel's envelope
  (``_fused_epoch_config``) and lives on ``cuda``;
* otherwise through the generic epoch: per step, ``calculate_loss`` under
  autograd and each optimizer's update (the JAX package's ``lax.scan`` body
  as a Python loop).  On the CPU the generic epoch runs, as the JAX package
  does off the TPU; ``fused=True`` makes a CPU model take the fused
  function's plain version.

There is no path on which a CUDA model inside the envelope trains without
the kernel: if the kernel cannot launch, the epoch raises.

Epoch layouts follow the JAX engine: ``(row, col)`` ids packed into one
int32 where they fit; the slot-domain one-gather epoch when shuffling
packable ids with at most 2% bucket-pad slots (``:331-375``, ``:409-445``),
whose pad slots are clamped into the item range before any gather
(``_unpack_rows``, ``:496-527``); the reorder path otherwise.

Randomness: per epoch one generator stream (seeded from the trainer's seed
and the epoch) gives the four Feistel keys, then the sampler's uniforms.  It
cannot reproduce JAX's threefry draws; ``draw_epoch`` is the one place the
draws are made, so a test can hand it JAX's keys and uniforms instead.
"""
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from collie_tpu_torch.data import ExplicitInteractions, Interactions, InteractionsDataLoader
from collie_tpu_torch.ops.device_sampling import (
    SPARES_PER_ROUND, bucketed_table_bytes, build_bucketed_complement_tables,
    complement_sample_negatives_bucketed, complement_sample_negatives_bucketed_grouped)
from collie_tpu_torch.ops.kernels.fused_mf_epoch import MAX_DIM, fused_mf_epoch
from collie_tpu_torch.ops.shuffle import draw_feistel_keys, feistel_permutation_from_keys

#: the JAX engine's bucketed-sampler table budget; above it JAX takes the
#: padded or CSR samplers, which are not ported yet
_SAMPLER_BUDGET_BYTES = 1024 * 2 ** 20
_KERNEL_LOSSES = {'hinge': ('hinge', False), 'adaptive_hinge': ('hinge', True),
                  'bpr': ('bpr', False), 'adaptive_bpr': ('bpr', True),
                  'warp': ('warp', False)}


def _fused_epoch_config(model, specs, active, loader, mesh=None) -> Optional[dict]:
    """Whether this (model, loader, optimizer) combination trains through
    the fused kernel; returns its config dict or None.  The envelope is the
    JAX engine's (``scan_engine.py:50-156``) without the VMEM budget, plus
    the CUDA kernel's own limit: ``embedding_dim <= MAX_DIM`` (256)."""
    if mesh is not None or not all(active):
        return None
    from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
    if type(model) is not MatrixFactorizationModel:
        return None
    if isinstance(loader.interactions, ExplicitInteractions):
        return None              # the explicit twin kernel is not ported
    hp = model.hparams
    if hp.get('dropout_p', 0.0) or hp.get('y_range') is not None:
        return None
    meta_names = ()
    if model.metadata_for_loss:
        weights = model.metadata_for_loss_weights
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
    if model.loss_function not in _KERNEL_LOSSES:
        return None
    loss_kind, adaptive = _KERNEL_LOSSES[model.loss_function]
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
    return {'adaptive': adaptive, 'loss_kind': loss_kind, 'meta_names': meta_names,
            'wd_emb': wd_emb, 'wd_bias': wd, 'emb_idx': emb_idx, 'bias_idx': bias_idx}


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
    ``sample_shape`` — float32 uniforms for exact sampling, item ids in
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


class _EpochClock:
    """Where an epoch's time goes: the shuffle, the sampler (with the batch
    assembly) and training, from CUDA events on the card (read after the
    caller's synchronisation) or the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.marks: List = []

    def mark(self) -> None:
        if self.cuda:
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        else:
            mark = time.perf_counter()
        self.marks = self.marks[-3:] + [mark]

    def split_ms(self) -> Dict[str, float]:
        """``shuffle_ms``, ``sample_ms`` and ``train_ms`` of the last epoch."""
        marks = self.marks[-4:]
        if self.cuda:
            marks[-1].synchronize()
            spans = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        else:
            spans = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        return dict(zip(('shuffle_ms', 'sample_ms', 'train_ms'), spans))


def build_scan_epoch_fns(model, specs, active: List[bool], loader, shuffle: bool,
                         mesh=None, training: bool = True, dedup_rounds: int = 1,
                         fused: Optional[bool] = None) -> Tuple[Callable, dict, int, int]:
    """Build an epoch function over ``loader``'s data.

    Returns ``(epoch_fn, data, num_steps, num_examples)``.  For
    ``training=True``: ``epoch_fn(params, opt_states, data, seed, epoch_idx)
    -> (params, opt_states, mean_loss)``, with ``epoch_fn.epoch_batches(seed,
    epoch_idx)`` (the epoch's batches), ``epoch_fn.split_ms()`` (shuffle,
    sampler and train milliseconds of the last epoch) and ``epoch_fn.fused``; for
    validation:
    ``epoch_fn(params, data, seed, epoch_idx) -> mean_loss``.  ``mean_loss``
    is a 0-d tensor on the model's device.  ``fused``: ``None`` takes the
    kernel on ``cuda`` inside the envelope; ``True`` requires the envelope
    and runs the fused function on any device (its plain version on the
    CPU)."""
    if mesh is not None:
        raise NotImplementedError('mesh training is not ported yet (ROADMAP Queue 1)')
    inter = loader.interactions
    if isinstance(inter, ExplicitInteractions):
        raise NotImplementedError('explicit-feedback training is not ported yet '
                                  '(ROADMAP Queue 1)')
    if training and not model._score_is_deterministic():
        raise NotImplementedError('training with dropout is not ported yet (ROADMAP Queue 1)')
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
    K = inter.num_negative_samples
    num_items = inter.num_items
    exact = inter.exact_negative_sampling

    def put(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=device)

    item_bits = max(int(num_items - 1).bit_length(), 1)
    packable = ((inter.num_users - 1) << item_bits | (num_items - 1)) < 2 ** 31
    data: Dict = {'mask_flat': put(np.concatenate([np.ones(n_used, dtype=np.float32),
                                                   np.zeros(pad, dtype=np.float32)]))}
    packed_np = None
    if packable:
        packed_np = (inter.mat.row.astype(np.int64) << item_bits
                     | inter.mat.col.astype(np.int64)).astype(np.int32)
        data['packed'] = put(packed_np)
    else:
        data['rows'] = put(inter.mat.row.astype(np.int32))
        data['cols'] = put(inter.mat.col.astype(np.int32))
    N_g = 0
    if exact:
        if bucketed_table_bytes(inter.mat) > _SAMPLER_BUDGET_BYTES:
            raise NotImplementedError(
                'the bucketed sampler tables exceed 1 GB; the padded and CSR samplers '
                'the JAX engine takes there are not ported yet (ROADMAP Queue 1)')
        specs_np, counts_np, users_g_np, pos_of_np = build_bucketed_complement_tables(
            inter.mat, inter.mat.row)
        data['bucket_specs'] = tuple((put(r), put(t)) for r, t in specs_np)
        data['row_counts'] = put(counts_np)
        data['users_g'] = put(users_g_np)
        N_g = len(users_g_np)
        if packable and shuffle and N_g >= 2 and (N_g - n) <= 0.02 * n:
            # slot-domain epoch: ids and a validity bit at grouped-slot
            # positions (bucket-pad slots -> mask 0), one row gather per epoch
            packed_slots = np.zeros(N_g, np.int32)
            packed_slots[pos_of_np] = packed_np
            slot_mask = np.zeros(N_g, np.int32)
            slot_mask[pos_of_np] = 1
            data['packed_slots'] = put(packed_slots)
            data['slot_mask'] = put(slot_mask)
            del data['packed'], data['mask_flat']
            S = -(-N_g // B)
            slot_tail = S * B - N_g
        else:
            data['pos_of'] = put(pos_of_np)
    W = K + SPARES_PER_ROUND * dedup_rounds
    clock = _EpochClock(device)

    def _draws(seed, epoch_idx):
        if 'packed_slots' in data:
            return draw_epoch(seed, epoch_idx, training, device, S * B - slot_tail,
                              (S * B - slot_tail, W), num_items, True)
        perm_n = n if shuffle and n >= 2 else None
        shape = (N_g, W) if exact else (S * B, K)
        return draw_epoch(seed, epoch_idx, training, device, perm_n, shape, num_items, exact)

    def _epoch_batches(seed, epoch_idx) -> Dict[str, torch.Tensor]:
        """The whole epoch on the device: ``users``/``pos_items`` ``[S, B]``
        int32, ``neg_items [S, B, K]`` int32 (in the item range), ``mask
        [S, B]`` float32."""
        keys, samples = _draws(seed, epoch_idx)
        item_mask = (1 << item_bits) - 1
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
        if exact:
            negs = complement_sample_negatives_bucketed(
                samples, idx, data['pos_of'], data['users_g'], data['bucket_specs'],
                data['row_counts'], num_items, K, dedup_rounds=dedup_rounds)
        else:
            negs = samples
        return {'users': users_flat.reshape(S, B),
                'pos_items': cols_flat.reshape(S, B),
                'mask': data['mask_flat'].reshape(S, B),
                'neg_items': negs.reshape(S, B, K).contiguous()}

    if not training:
        def val_epoch_fn(params, data_, seed, epoch_idx):
            batches = _epoch_batches(seed, epoch_idx)
            with torch.no_grad():
                losses = [model.calculate_loss(params, {k: v[s] for k, v in batches.items()},
                                               training=False) for s in range(S)]
            return torch.stack(losses).mean()

        return val_epoch_fn, data, S, n_used

    cfg = _fused_epoch_config(model, specs, active, loader, mesh)
    if fused and cfg is None:
        raise ValueError('fused=True but this model is outside the kernel\'s envelope')
    use_fused = cfg is not None and (fused or device.type == 'cuda')

    if use_fused:
        emb_idx, bias_idx = cfg['emb_idx'], cfg['bias_idx']
        meta_rows = (torch.stack([torch.as_tensor(np.asarray(model.metadata_for_loss[m]),
                                                  device=device).to(torch.int32)
                                  for m in cfg['meta_names']])
                     if cfg['meta_names'] else None)
        meta_weights = tuple(float(model.metadata_for_loss_weights[m])
                             for m in cfg['meta_names'])

        def epoch_fn(params, opt_states, data_, seed, epoch_idx):
            clock.mark()
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
                meta_weights=meta_weights, wd_emb=cfg['wd_emb'], wd_bias=cfg['wd_bias'])
            new_params = {**params, 'user_embeddings': ue, 'item_embeddings': ie,
                          'item_biases': ib}
            if cfg['wd_bias']:
                # user biases get zero data gradient from pairwise ranking
                # losses: their sgd + coupled decay is b *= (1 - lr*wd) per step
                rate = torch.tensor(lr_b, dtype=torch.float32) * cfg['wd_bias']
                decay = (1.0 - rate) ** S
                new_params['user_biases'] = params['user_biases'] * decay.to(device)
            new_states = list(opt_states)
            new_states[emb_idx] = dataclasses.replace(
                emb_state, count=emb_state.count + S, adam_count=cnt,
                mu={'item_embeddings': mu_i, 'user_embeddings': mu_u},
                nu={'item_embeddings': nu_i, 'user_embeddings': nu_u})
            new_states[bias_idx] = dataclasses.replace(bias_state, count=bias_state.count + S)
            clock.mark()
            return new_params, tuple(new_states), losses.mean()
    else:
        def epoch_fn(params, opt_states, data_, seed, epoch_idx):
            clock.mark()
            batches = _epoch_batches(seed, epoch_idx)
            clock.mark()
            trained = [k for spec, on in zip(specs, active) if on for k in spec.keys]
            states = list(opt_states)
            losses = []
            for s in range(S):
                batch = {k: v[s] for k, v in batches.items()}
                leaves = {k: (v.detach().requires_grad_() if k in trained else v.detach())
                          for k, v in params.items()}
                loss = model.calculate_loss(leaves, batch, training=True)
                grads = dict(zip(trained, torch.autograd.grad(
                    loss, [leaves[k] for k in trained], allow_unused=True)))
                with torch.no_grad():
                    for i, spec in enumerate(specs):
                        if not active[i]:
                            continue
                        sub_params = {k: params[k] for k in spec.keys}
                        sub_grads = {k: (grads[k] if grads[k] is not None
                                         else torch.zeros_like(params[k]))
                                     for k in spec.keys}
                        updates, states[i] = spec.transform.update(
                            sub_grads, states[i], sub_params)
                        params = {**params,
                                  **{k: sub_params[k] + updates[k] for k in spec.keys}}
                losses.append(loss.detach())
            clock.mark()
            return params, tuple(states), torch.stack(losses).mean()

    epoch_fn.split_ms = clock.split_ms
    epoch_fn.fused = use_fused
    epoch_fn.epoch_batches = _epoch_batches
    return epoch_fn, data, S, n_used

