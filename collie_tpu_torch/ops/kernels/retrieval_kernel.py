"""Fused MF tile scoring + per-tile top-k: the retrieval kernel and its plain twin.

Port of ``collie_tpu/ops/pallas/retrieval_kernel.py``.  The Pallas TPU kernel
``_topk_tile_kernel`` (``:36``) becomes the hand-written CUDA kernel in
``collie_tpu_torch/csrc/topk_tile.cu`` (see its header for the design and its
bound at the serving shape).  For each item tile it scores
``user_emb . item_emb + item_bias`` for a block of users, masks the catalog
tail to ``finfo(float32).min`` and keeps the tile's top-k, ties going to the
lowest item id; only the ``[n_tiles, B, k]`` candidates reach device memory.
The merge over tiles (a stable descending sort, so equal scores keep the
lowest item id as ``lax.top_k`` does) and the per-user bias (rank-invariant)
run here in PyTorch, as the JAX package leaves them to XLA.

``mf_topk_retrieve`` launches the kernel for CUDA tensors and raises on
anything it does not take; it runs ``mf_topk_retrieve_plain`` only for
tensors that lie on the CPU.  ``mf_topk_retrieve.launches`` counts kernel
launches.
"""
import ctypes
from typing import Tuple

import torch

from collie_tpu_torch.ops.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
MAX_K = 128
SOURCE = 'topk_tile.cu'


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last axis,
    equal values in ascending index order (``lax.top_k``'s tie rule, which
    ``torch.topk`` does not promise)."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _check_inputs(user_embeddings, user_biases, item_embeddings, item_biases,
                  k: int, tile: int) -> None:
    tensors = (user_embeddings, user_biases, item_embeddings, item_biases)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'mf_topk_retrieve: inputs on several devices {devices}')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('mf_topk_retrieve takes float32 tensors, got '
                        f'{[t.dtype for t in tensors]}')
    if user_embeddings.dim() != 2 or item_embeddings.dim() != 2:
        raise ValueError('user_embeddings and item_embeddings must be 2-D')
    B, D = user_embeddings.shape
    num_items = item_embeddings.shape[0]
    if item_embeddings.shape[1] != D:
        raise ValueError(f'embedding dims differ: {D} vs {item_embeddings.shape[1]}')
    if tuple(user_biases.shape) != (B,) or tuple(item_biases.shape) != (num_items,):
        raise ValueError('user_biases must be [B] and item_biases [num_items]')
    if not 1 <= k <= MAX_K:
        raise ValueError(f'kernel supports 1 <= k <= {MAX_K}, got {k}')
    if k > num_items:
        raise ValueError(f'k ({k}) must not exceed the number of items ({num_items})')
    if tile < 1:
        raise ValueError(f'tile must be positive, got {tile}')
    if B < 1 or D < 1:
        raise ValueError(f'empty user block {tuple(user_embeddings.shape)}')


def _merge_tiles(tile_scores: torch.Tensor, tile_ids: torch.Tensor,
                 user_biases: torch.Tensor, k: int):
    """``[n_tiles, B, k]`` candidates -> final ``(ids [B, k], scores [B, k])``.
    Candidates are laid out tile-major per user, so the stable sort's order
    among equal scores is ascending item id."""
    n_tiles, B, _ = tile_scores.shape
    cand_scores = tile_scores.permute(1, 0, 2).reshape(B, n_tiles * k)
    cand_ids = tile_ids.permute(1, 0, 2).reshape(B, n_tiles * k)
    top_scores, idx = stable_topk(cand_scores, k)
    return (torch.gather(cand_ids, 1, idx),
            top_scores + user_biases[:, None])


def topk_tiles_plain(user_embeddings: torch.Tensor,
                     item_embeddings: torch.Tensor,
                     item_biases: torch.Tensor,
                     k: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: per-tile top-k candidates
    ``(scores, ids)``, each ``[n_tiles, B, k]``."""
    B = user_embeddings.shape[0]
    num_items = item_embeddings.shape[0]
    n_tiles = -(-num_items // tile)
    device = user_embeddings.device
    out_scores = torch.empty((n_tiles, B, k), dtype=torch.float32, device=device)
    out_ids = torch.empty((n_tiles, B, k), dtype=torch.int32, device=device)
    for t in range(n_tiles):
        base = t * tile
        stop = min(base + tile, num_items)
        scores = torch.full((B, tile), NEG_INF, dtype=torch.float32, device=device)
        scores[:, :stop - base] = (user_embeddings @ item_embeddings[base:stop].T
                                   + item_biases[base:stop][None, :])
        values, idx = stable_topk(scores, k)
        # a tile narrower than k pads with (finfo.min, tile base), as the kernel
        pad = k - values.shape[1]
        if pad:
            values = torch.nn.functional.pad(values, (0, pad), value=NEG_INF)
            idx = torch.nn.functional.pad(idx, (0, pad), value=0)
        out_scores[t] = values
        out_ids[t] = (base + idx).to(torch.int32)
    return out_scores, out_ids


def mf_topk_retrieve_plain(user_embeddings: torch.Tensor,
                           user_biases: torch.Tensor,
                           item_embeddings: torch.Tensor,
                           item_biases: torch.Tensor,
                           k: int = 10,
                           tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``mf_topk_retrieve``: the same tiles, the same per-tile
    selection and the same merge, with ``torch.matmul`` in place of the
    kernel's FMAs.  Used for CPU tensors and as the kernel's reference."""
    _check_inputs(user_embeddings, user_biases, item_embeddings, item_biases, k, tile)
    tile_scores, tile_ids = topk_tiles_plain(user_embeddings, item_embeddings,
                                             item_biases, k, tile)
    return _merge_tiles(tile_scores, tile_ids, user_biases, k)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut a bare int to 32 bits
    lib.collie_topk_tile.argtypes = [p, p, p, i, i, i, i, i, p, p, p]
    lib.collie_topk_tile.restype = i
    lib.collie_topk_tile_users_per_block.argtypes = [i, i]
    lib.collie_topk_tile_users_per_block.restype = i
    return lib


def topk_tiles_cuda(user_embeddings: torch.Tensor,
                    item_embeddings: torch.Tensor,
                    item_biases: torch.Tensor,
                    k: int, tile: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: per-tile candidates
    ``(scores, ids)``, each ``[n_tiles, B, k]``."""
    tensors = (user_embeddings, item_embeddings, item_biases)
    if any(t.device.type != 'cuda' for t in tensors):
        raise ValueError('topk_tiles_cuda takes CUDA tensors')
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError('topk_tiles_cuda takes float32 tensors')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('topk_tiles_cuda takes contiguous tensors')
    B, D = user_embeddings.shape
    num_items = item_embeddings.shape[0]
    if item_embeddings.shape[1] != D or tuple(item_biases.shape) != (num_items,):
        raise ValueError('item_embeddings must be [num_items, D] and item_biases [num_items]')
    if not 1 <= k <= MAX_K:
        raise ValueError(f'kernel supports 1 <= k <= {MAX_K}, got {k}')
    if max(B, num_items, tile) >= 2 ** 31:
        raise ValueError('sizes must fit in int32')
    lib = _library()
    if lib.collie_topk_tile_users_per_block(D, tile) == 0:
        raise ValueError(f'tile={tile} with D={D} does not fit in shared memory')
    n_tiles = -(-num_items // tile)
    device = user_embeddings.device
    out_scores = torch.empty((n_tiles, B, k), dtype=torch.float32, device=device)
    out_ids = torch.empty((n_tiles, B, k), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_topk_tile(
            user_embeddings.data_ptr(), item_embeddings.data_ptr(),
            item_biases.data_ptr(), B, D, num_items, tile, k,
            out_scores.data_ptr(), out_ids.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'collie_topk_tile launch failed: cudaError_t {err}')
    mf_topk_retrieve.launches += 1
    return out_scores, out_ids


def mf_topk_retrieve(user_embeddings: torch.Tensor,
                     user_biases: torch.Tensor,
                     item_embeddings: torch.Tensor,
                     item_biases: torch.Tensor,
                     k: int = 10,
                     tile: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused MF top-k over the full catalog.

    ``user_embeddings [B, D]`` (the already-gathered user block),
    ``user_biases [B]``, ``item_embeddings [num_items, D]``,
    ``item_biases [num_items]`` -> ``(top_ids [B, k] int32,
    top_scores [B, k] float32)``; ``k <= 128``.  CUDA tensors go through the
    kernel, CPU tensors through ``mf_topk_retrieve_plain``.
    """
    _check_inputs(user_embeddings, user_biases, item_embeddings, item_biases, k, tile)
    device = user_embeddings.device
    if device.type == 'cpu':
        tile_scores, tile_ids = topk_tiles_plain(user_embeddings, item_embeddings,
                                                 item_biases, k, tile)
    elif device.type == 'cuda':
        tile_scores, tile_ids = topk_tiles_cuda(
            user_embeddings.contiguous(), item_embeddings.contiguous(),
            item_biases.contiguous(), k, tile)
    else:
        raise ValueError(f'mf_topk_retrieve runs on cuda or cpu, not {device}')
    return _merge_tiles(tile_scores, tile_ids, user_biases, k)


mf_topk_retrieve.launches = 0
