"""Fused MF scoring + running top-k: the retrieval kernel and its plain twin.

Port of ``collie_tpu/ops/pallas/retrieval_kernel.py``.  The Pallas TPU kernel
``_topk_tile_kernel`` (``:36``) becomes the hand-written CUDA kernel in
``collie_tpu_torch/csrc/topk_tile.cu`` (see its header for the design and its
bound at the serving shape).  It scores ``user_emb . item_emb + item_bias``
for every user and item and keeps, for each user and each contiguous item
range, the range's top-k, ties going to the lowest item id; only the
``[n_ranges, B, k]`` candidates reach device memory.  ``topk_plan`` picks the
launch: the user chunk a block holds, where the running lists live and the
range width, from B, D, k, the catalog and the SM count.  The merge over
ranges (a stable descending sort, so equal scores keep the lowest item id as
``lax.top_k`` does) and the per-user bias (rank-invariant) run here in
PyTorch, as the JAX package leaves them to XLA.

``mf_topk_retrieve`` launches the kernel for CUDA tensors and raises on
anything it does not take; it runs ``mf_topk_retrieve_plain`` only for
tensors that lie on the CPU.  ``mf_topk_retrieve.launches`` counts kernel
launches.
"""
import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from collie_tpu_torch.ops.kernels import _build

NEG_INF = float(torch.finfo(torch.float32).min)
MAX_K = 128
SOURCE = 'topk_tile.cu'

# the kernel's geometry (csrc/topk_tile.cu): items a tile, embedding dims a
# stage holds, floats a transposed stage row (and a score row) and a landing
# row take, and the user chunks it is built for
TILE_ITEMS = 128
CHUNK_DIMS = 32
ITEM_ROW = TILE_ITEMS + 4
LANDING_ROW = CHUNK_DIMS + 4
USER_CHUNKS = (32, 64, 128)
MAX_SHARED_BYTES = 232448      # what one block may use on sm_90
SM_SHARED_BYTES = 233472       # an SM's shared memory; 1 KB of it is reserved per block
REGISTERS = 192                # about what ptxas gives a thread of the kernel
H100_SMS = 132


@dataclass(frozen=True)
class TopkPlan:
    """One launch of the kernel: ``n_chunks`` chunks of ``user_chunk``
    users times ``n_ranges`` ranges of ``tiles_per_range`` tiles; the
    running lists in shared memory or in a scratch of ``[blocks,
    user_chunk, k]``."""
    user_chunk: int
    lists_in_shared: bool
    n_chunks: int
    tiles_per_range: int
    n_ranges: int
    shared_bytes: int
    threads: int
    blocks_per_sm: int

    @property
    def range_width(self) -> int:
        return self.tiles_per_range * TILE_ITEMS

    @property
    def blocks(self) -> int:
        return self.n_chunks * self.n_ranges


def topk_shared_bytes(user_chunk: int, D: int, k: int, lists_in_shared: bool) -> int:
    """Shared memory of one block: user rows (D padded to 32), two item
    stages and their two landing slots, the score tile, each user's
    threshold and flag, and the running lists where they live there."""
    dims = -(-D // CHUNK_DIMS) * CHUNK_DIMS
    return 4 * (user_chunk * dims + 2 * CHUNK_DIMS * ITEM_ROW + 2 * TILE_ITEMS * LANDING_ROW
                + user_chunk * ITEM_ROW
                + 3 * user_chunk + (2 * user_chunk * k if lists_in_shared else 0))


def topk_plan(B: int, D: int, k: int, num_items: int, sms: int = H100_SMS) -> TopkPlan:
    """The launch plan for ``B`` users, dim ``D``, top ``k`` over
    ``num_items`` items on a card of ``sms`` SMs.

    The user chunk is the smallest of 32, 64, 128 that holds B (128 above),
    or a smaller one where its shared memory does not fit; the running
    lists go to shared memory where they fit, else to device memory.  The
    grid is ``n_chunks`` x ``n_ranges`` blocks, with as many ranges as fill
    every SM with the blocks it holds at once, each range a whole number of
    128-item tiles.
    """
    want = next((c for c in USER_CHUNKS if c >= B), USER_CHUNKS[-1])
    options = [(chunk, lists) for chunk in sorted((c for c in USER_CHUNKS if c <= want),
                                                  reverse=True) for lists in (True, False)]
    for chunk, lists in options:
        shared = topk_shared_bytes(chunk, D, k, lists)
        if shared <= MAX_SHARED_BYTES:
            break
    else:
        raise ValueError(f'D={D} with k={k} does not fit in shared memory')
    threads = 2 * chunk
    blocks_per_sm = max(1, min(SM_SHARED_BYTES // (shared + 1024), 2048 // threads,
                               65536 // (REGISTERS * threads)))
    n_chunks = -(-B // chunk)
    n_tiles = -(-num_items // TILE_ITEMS)
    want_ranges = max(1, sms * blocks_per_sm // n_chunks)
    tiles_per_range = -(-n_tiles // want_ranges)
    n_ranges = -(-n_tiles // tiles_per_range)
    return TopkPlan(chunk, lists, n_chunks, tiles_per_range, n_ranges, shared, threads,
                    blocks_per_sm)


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
    """``[n_ranges, B, k]`` candidates -> final ``(ids [B, k], scores [B, k])``.
    Candidates are laid out range-major per user, ranges in increasing item
    order and each range's list in (score descending, id ascending) order,
    so the stable sort's order among equal scores is ascending item id."""
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
    """Plain PyTorch version of the kernel: the top-k candidates
    ``(scores, ids)``, each ``[n_ranges, B, k]``, of each range of ``tile``
    items (the kernel's range width, or the tile of ``mf_topk_retrieve``).
    A range with fewer than k items pads with (finfo.min, its first id)."""
    B = user_embeddings.shape[0]
    num_items = item_embeddings.shape[0]
    n_ranges = -(-num_items // tile)
    device = user_embeddings.device
    out_scores = torch.full((n_ranges, B, k), NEG_INF, dtype=torch.float32, device=device)
    out_ids = torch.empty((n_ranges, B, k), dtype=torch.int32, device=device)
    for t in range(n_ranges):
        base = t * tile
        stop = min(base + tile, num_items)
        scores = user_embeddings @ item_embeddings[base:stop].T + item_biases[base:stop][None, :]
        values, idx = stable_topk(scores, k)
        kept = values.shape[1]
        out_scores[t, :, :kept] = values
        out_ids[t, :, :kept] = (base + idx).to(torch.int32)
        out_ids[t, :, kept:] = base
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
    lib.collie_topk_tile.argtypes = [p, p, p] + [i] * 6 + [p] * 5
    lib.collie_topk_tile.restype = i
    lib.collie_topk_shared_bytes.argtypes = [i] * 4
    lib.collie_topk_shared_bytes.restype = ctypes.c_longlong
    return lib


def topk_tiles_cuda(user_embeddings: torch.Tensor,
                    item_embeddings: torch.Tensor,
                    item_biases: torch.Tensor,
                    k: int, tile: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream: per-range candidates
    ``(scores, ids)``, each ``[n_ranges, B, k]`` of ``topk_plan`` for the
    card.  ``tile``, the plain version's tile, does not shape the launch and
    is taken so the two are called alike."""
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
    if not 1 <= k <= min(MAX_K, num_items):
        raise ValueError(f'kernel supports 1 <= k <= min({MAX_K}, num_items), got {k}')
    if max(B, num_items) >= 2 ** 31:
        raise ValueError('sizes must fit in int32')
    device = user_embeddings.device
    plan = topk_plan(B, D, k, num_items,
                     torch.cuda.get_device_properties(device).multi_processor_count)
    lib = _library()
    out_scores = torch.empty((plan.n_ranges, B, k), dtype=torch.float32, device=device)
    out_ids = torch.empty((plan.n_ranges, B, k), dtype=torch.int32, device=device)
    lists = (None, None)
    if not plan.lists_in_shared:
        lists = tuple(torch.empty((plan.blocks, plan.user_chunk, k), dtype=dtype, device=device)
                      for dtype in (torch.float32, torch.int32))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_topk_tile(
            user_embeddings.data_ptr(), item_embeddings.data_ptr(), item_biases.data_ptr(),
            B, D, num_items, k, plan.user_chunk, plan.tiles_per_range,
            *[None if t is None else t.data_ptr() for t in lists],
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
    kernel, whose ranges ``topk_plan`` sizes; CPU tensors through
    ``mf_topk_retrieve_plain``, in tiles of ``tile`` items.  Both give the
    same top-k: the merge of any partition of the catalog into ranges.
    """
    _check_inputs(user_embeddings, user_biases, item_embeddings, item_biases, k, tile)
    device = user_embeddings.device
    if device.type == 'cpu':
        tile_scores, tile_ids = topk_tiles_plain(user_embeddings, item_embeddings,
                                                 item_biases, k, tile)
    elif device.type == 'cuda':
        tile_scores, tile_ids = topk_tiles_cuda(
            user_embeddings.contiguous(), item_embeddings.contiguous(),
            item_biases.contiguous(), k)
    else:
        raise ValueError(f'mf_topk_retrieve runs on cuda or cpu, not {device}')
    return _merge_tiles(tile_scores, tile_ids, user_biases, k)


mf_topk_retrieve.launches = 0
