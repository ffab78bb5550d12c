"""Batch top-k retrieval (serving path).

Port of ``collie_tpu/retrieval.py`` (single device; the item-sharded tier is
not ported yet).  Three paths, chosen as in the JAX package:

* **dense**: when the ``[batch, num_items]`` score block fits the budget
  (``COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB``, 512 default), score the whole
  catalog with one matmul and take a stable top-k;
* **kernel**: beyond the budget, plain float32 MF without seen filtering
  and ``k <= 128`` goes through the hand-written CUDA kernel
  (``ops/kernels/retrieval_kernel.py``), which never materializes the block;
* **blockwise**: otherwise items are scored in tiles and a running top-k is
  merged per tile, so memory is ``O(batch * (k + tile))``.

Every top-k here is a stable selection: equal scores go to the lowest item
id, as ``lax.top_k`` does, so ids equal the JAX package's on ties too.
Masked scores are ``finfo(float32).min``, not ``-inf``, so when fewer than
``k`` items survive the seen filter the lowest-index masked ids fill the
row, as in JAX.  Seen filtering is a membership test against the train(+val)
CSR, re-read from the loaders on every call.
"""
import os
from typing import Tuple

import numpy as np
import torch

from collie_tpu_torch.ops.device_sampling import csr_keys, keys_contain
from collie_tpu_torch.ops.kernels.retrieval_kernel import MAX_K, NEG_INF, \
    mf_topk_retrieve, stable_topk


def _require_seen(filter_seen: bool, seen) -> None:
    """A missing seen CSR must raise clearly at call time."""
    if filter_seen and seen is None:
        raise ValueError(
            'filter_seen=True requires seen=(indptr, cols) CSR '
            'arrays of the interactions to exclude')


def _merge_topk(top_scores, top_ids, tile_scores, tile_ids, k: int):
    """Merge the running per-user top-k with a new scored tile; the running
    entries come first, so on ties earlier item ids win."""
    scores = torch.cat([top_scores, tile_scores], dim=1)
    ids = torch.cat([top_ids, tile_ids], dim=1)
    new_scores, idx = stable_topk(scores, k)
    return new_scores, torch.gather(ids, 1, idx)


def _dense_budget_bytes() -> int:
    return int(os.environ.get('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', '512')) * (1 << 20)


def build_retrieval_fn(model, k: int = 10, item_tile: int = 4096,
                       filter_seen: bool = False):
    """``(params, user_ids[B], seen) -> (top_ids[B, k], top_scores[B, k])``.

    ``user_ids``: int64 tensor on the model's device.  ``seen``:
    ``(indptr, cols)`` tensors of the CSR of interactions to exclude (train
    and/or val, rows sorted), or ``None`` when ``filter_seen`` is off.
    """
    from collie_tpu_torch.models.base import BasePipeline

    num_items = model.hparams['num_items']
    dense_budget = _dense_budget_bytes()
    # the budget prices only the [B, num_items] score block: sound for a real
    # score_item_block override, not for the base hook, whose intermediates
    # for MLP-family models dwarf the block
    dense_ok = type(model).score_item_block is not BasePipeline.score_item_block
    kernel_fn = _maybe_kernel_retrieve(model, k, item_tile, filter_seen)
    n_tiles = -(-num_items // item_tile)

    def _blockwise(params, user_ids, keys):
        B = user_ids.shape[0]
        device = user_ids.device
        top_scores = torch.full((B, k), NEG_INF, dtype=torch.float32, device=device)
        top_ids = torch.zeros((B, k), dtype=torch.int64, device=device)
        offsets = torch.arange(item_tile, device=device)
        for tile_idx in range(n_tiles):
            item_ids = tile_idx * item_tile + offsets
            # clamp the tail before the gather: out of range is a device assert
            safe = item_ids.clamp(max=num_items - 1)
            scores = model.score_item_block(params, user_ids, safe)
            valid = (item_ids < num_items)[None, :]
            if filter_seen:
                valid = valid & ~keys_contain(keys, user_ids[:, None], safe[None, :])
            scores = torch.where(valid, scores, NEG_INF)
            top_scores, top_ids = _merge_topk(
                top_scores, top_ids, scores, item_ids.expand(B, item_tile), k)
        return top_ids, top_scores

    def retrieve(params, user_ids, seen=None):
        _require_seen(filter_seen, seen)
        B = user_ids.shape[0]
        within_budget = B * num_items * 4 <= dense_budget
        with torch.no_grad():
            if kernel_fn is not None and not within_budget:
                return kernel_fn(params, user_ids)
            keys = csr_keys(*seen) if filter_seen else None
            if dense_ok and within_budget:
                item_ids = torch.arange(num_items, device=user_ids.device)
                scores = model.score_item_block(params, user_ids, item_ids)
                if filter_seen:
                    scores = torch.where(
                        keys_contain(keys, user_ids[:, None], item_ids[None, :]),
                        NEG_INF, scores)
                top_scores, top_ids = stable_topk(scores, k)
                return top_ids, top_scores
            return _blockwise(params, user_ids, keys)

    return retrieve


def _maybe_kernel_retrieve(model, k: int, item_tile: int, filter_seen: bool):
    """The CUDA kernel path for plain MF retrieval, or None.

    Applies to a ``MatrixFactorizationModel`` with float32 params, without
    seen filtering, and ``k <= 128``: per item tile the kernel scores and
    keeps the tile's top-k on chip, so the [batch, num_items] block never
    reaches device memory.  The monotone ``y_range`` sigmoid is applied to
    the k winners afterwards (it cannot change the ranking).
    """
    from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel

    if filter_seen or type(model) is not MatrixFactorizationModel or k > MAX_K:
        return None
    if any(v.dtype != torch.float32 for v in model.params.values()):
        return None  # bf16 tables: the kernel's envelope is float32

    y_range = model.hparams.get('y_range')

    def retrieve(params, user_ids):
        top_ids, top_scores = mf_topk_retrieve(
            params['user_embeddings'][user_ids], params['user_biases'][user_ids],
            params['item_embeddings'], params['item_biases'],
            k=k, tile=item_tile)
        if y_range is not None:
            top_scores = torch.sigmoid(top_scores) * (y_range[1] - y_range[0]) \
                + y_range[0]
        return top_ids, top_scores

    return retrieve


def _seen_arrays(model) -> Tuple[torch.Tensor, torch.Tensor]:
    """Current train(+val) interactions as sorted-CSR tensors on the model's
    device."""
    seen_csr = model.train_loader.mat.tocsr()
    if model.val_loader is not None:
        seen_csr = seen_csr + model.val_loader.mat.tocsr()
    seen_csr = seen_csr.tocsr()
    seen_csr.sort_indices()
    return (torch.as_tensor(seen_csr.indptr.astype(np.int64), device=model.device),
            torch.as_tensor(seen_csr.indices.astype(np.int64), device=model.device))


def recommend(model,
              user_ids,
              k: int = 10,
              filter_seen: bool = True,
              item_tile: int = 4096) -> Tuple[np.ndarray, np.ndarray]:
    """Top-k recommendations for a batch of users.

    Returns ``(item_ids [B, k], scores [B, k])`` as numpy.  ``filter_seen``
    excludes items present in the model's train (and val, if any) loaders,
    matching ``get_item_predictions(unseen_items_only=True)`` (reference
    ``base_pipeline.py:705-718``) but batched and on the device.  The seen set
    is re-read from the loaders on every call.
    """
    num_items = model.hparams['num_items']
    if k > num_items:
        raise ValueError(
            f'``k`` ({k}) must not exceed the number of items ({num_items})'
        )
    seen = _seen_arrays(model) if filter_seen else None
    retrieve = build_retrieval_fn(model, k=k, item_tile=item_tile,
                                  filter_seen=filter_seen)
    top_ids, top_scores = retrieve(model.params, model._ids(user_ids), seen)
    return (top_ids.cpu().numpy().astype(np.int32, copy=False),
            top_scores.cpu().numpy())
