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

``stable_topk``, the port's every top-k (the dense serving path, MAP@k, the
blockwise, range and mesh merges), is on the card the exact selection kernel
of ``collie_tpu_torch/csrc/topk_select.cu`` (``topk_select_cuda``; see its
header for the design, the order it gives NaN and signed zeros, and its
bound), which reads the scores once; the library's plan
(``collie_topk_select_plan``, asked once a shape by ``select_plan``) cuts
each row into segments from the card's resident blocks and takes a large k
in rounds.  It takes float32, float16 and bfloat16 at any k and raises on other
dtypes.  Its plain version ``stable_topk_plain``, a full stable sort, serves
CPU tensors and is the kernel's reference.  ``stable_topk.launches`` counts
the kernel's selections.
"""
import ctypes
import functools
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

SELECT_SOURCE = 'topk_select.cu'
SELECT_ABI = 2
#: bytes an element of each dtype the selection kernel reads
SELECT_DTYPES = {torch.float32: 4, torch.float16: 2, torch.bfloat16: 2}
INT32_MAX = 2 ** 31 - 1


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


def stable_topk_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``stable_topk`` by a full stable descending sort: the CPU's path and
    the selection kernel's reference on the card."""
    values, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


@dataclass(frozen=True)
class SelectPlan:
    """A selection's launches, as ``collie_topk_select_plan`` gives them:
    ``rounds`` rounds (one unless k passes what one block holds), the first
    round's ``segments`` a row of ``segment_length`` elements and its
    ``round_k``, and the ``scratch_keys`` of pass 1 (0: one segment a row)."""
    rounds: int
    segments: int
    segment_length: int
    round_k: int
    scratch_keys: int


def _select_library() -> ctypes.CDLL:
    lib = _build.load(SELECT_SOURCE, abi=('collie_topk_select_abi', SELECT_ABI))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.collie_topk_select_plan.argtypes = [ll, i, i, i, p]
    lib.collie_topk_select_plan.restype = ll
    lib.collie_topk_select.argtypes = [p, i, ll, i, i, p, ll, p, p, p]
    lib.collie_topk_select.restype = i
    return lib


def _check_select(scores: torch.Tensor, k: int) -> None:
    if scores.dtype not in SELECT_DTYPES:
        raise TypeError(f'topk_select_cuda takes {sorted(map(str, SELECT_DTYPES))}, '
                        f'got {scores.dtype}')
    if scores.dim() < 1:
        raise ValueError('topk_select_cuda takes a tensor of at least one axis')
    if k < 0:
        raise ValueError(f'topk_select_cuda takes k >= 0, got {k}')
    if scores.shape[-1] > INT32_MAX:
        raise ValueError(f'topk_select_cuda takes rows of at most {INT32_MAX}, '
                         f'got {scores.shape[-1]}')
    if scores.device.type != 'cuda':
        raise ValueError(f'topk_select_cuda takes a CUDA tensor, not {scores.device}')


@functools.lru_cache(maxsize=4096)
def _select_plan(device_index: int, rows: int, n: int, k: int, elem_bytes: int) -> SelectPlan:
    """``collie_topk_select_plan`` on card ``device_index``; a plan depends
    on nothing else, so each shape asks the library once."""
    first = (ctypes.c_int * 4)()
    with torch.cuda.device(device_index):
        scratch = _select_library().collie_topk_select_plan(rows, n, k, elem_bytes, first)
    if scratch < 0:
        raise RuntimeError(f'collie_topk_select_plan failed: cudaError_t {-scratch}')
    return SelectPlan(*first, scratch)


def select_plan(scores: torch.Tensor, k: int) -> SelectPlan:
    """The selection kernel's plan for ``topk_select_cuda(scores, k)`` on
    ``scores``' card (``k`` cut to the row; ``scores`` not empty)."""
    _check_select(scores, k)
    n = scores.shape[-1]
    return _select_plan(scores.device.index, scores.numel() // n, n, min(k, n),
                        SELECT_DTYPES[scores.dtype])


def topk_select_cuda(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the selection kernel (``csrc/topk_select.cu``) on the current
    stream: ``stable_topk`` of a CUDA float32, float16 or bfloat16 tensor,
    any ``k >= 0`` (cut to the last axis, as the sort's slice cuts it).
    Leading axes are flattened; a non-contiguous input is copied first."""
    _check_select(scores, k)
    scores = scores.contiguous()
    device = scores.device
    n = scores.shape[-1]
    k = min(k, n)
    shape = (*scores.shape[:-1], k)
    values = torch.empty(shape, dtype=scores.dtype, device=device)
    indices = torch.empty(shape, dtype=torch.int64, device=device)
    if values.numel() == 0:
        return values, indices
    rows, elem_bytes = values.numel() // k, SELECT_DTYPES[scores.dtype]
    plan = _select_plan(device.index, rows, n, k, elem_bytes)
    seg_keys = (torch.empty(plan.scratch_keys, dtype=torch.int64, device=device)
                if plan.scratch_keys else None)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _select_library().collie_topk_select(
            scores.data_ptr(), elem_bytes, rows, n, k,
            None if seg_keys is None else seg_keys.data_ptr(), plan.scratch_keys,
            values.data_ptr(), indices.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'collie_topk_select launch failed: cudaError_t {err}')
    stable_topk.launches += 1
    return values, indices


def stable_topk(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the ``k`` largest entries along the last axis,
    equal values in ascending index order (``lax.top_k``'s tie rule, which
    ``torch.topk`` does not promise), as ``stable_topk_plain``'s sort gives
    them bit for bit, NaN and signed zeros included.  A CUDA tensor goes
    through the selection kernel (float32, float16 or bfloat16; any other
    dtype raises), a CPU tensor through the sort.
    ``stable_topk.launches`` counts the kernel's selections."""
    if scores.device.type == 'cuda':
        return topk_select_cuda(scores, k)
    if scores.device.type == 'cpu':
        return stable_topk_plain(scores, k)
    raise ValueError(f'stable_topk runs on cuda or cpu, not {scores.device}')


stable_topk.launches = 0


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
