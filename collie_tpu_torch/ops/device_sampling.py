"""On-device negative sampling and membership tests against interaction CSRs.

Port of ``collie_tpu/ops/device_sampling.py``: the CSR tables' host builder
copied bit-equal (``build_complement_tables`` ``:45``), the degree-bucketed
tables' builder (``:87``) rewritten for the ids' device
(``build_bucketed_complement_tables_torch``, the one builder, on the card
and on the CPU: one sort of the pairs and one of the examples, with one
host read of the buckets' sizes) and the samplers:

* the two exact samplers the training engine takes: the degree-bucketed
  complement sampler inside its table budget (the grouped sampler of
  ``:237-325`` with its spare-based dedup, and the reorder wrapper of
  ``:198``), and the CSR complement sampler (``:411``) above it.  On CUDA
  tensors the grouped sampler is one launch of the hand-written kernel
  ``collie_tpu_torch/csrc/bucketed_sample.cu`` (draw, count and dedup of
  every slot in registers), which equals its plain torch version
  (``complement_sample_negatives_bucketed_grouped_plain``, the CPU's path)
  value for value.  The JAX
  package's padded sampler (``:339``) is bit-identical to its CSR sampler,
  so the port has none: ``COLLIE_TPU_SAMPLER=padded`` takes the CSR
  sampler, whose negatives are the padded sampler's;
* ``distinct_complement_sample_negatives_impl`` (``:461``, K distinct
  values per row; not used by the engine), ``contains_pairs`` (``:525``),
  the redraw-rounds ``sample_negatives_impl`` (``:572``) and
  ``pairs_in_csr`` (``:541``).

Randomness comes in as inputs, never from a generator here: each sampler
takes its float32 uniforms (or ``randint`` draws) as one block per round,
stacked on a leading axis in the order of JAX's ``jax.random.split`` of the
sampler's key, so a test can hand it JAX's draws.  The JAX wrappers'
public names (``sample_negatives``, ``complement_sample_negatives``,
``distinct_complement_sample_negatives``) name the same functions here.

Complement sampling: for user ``u`` with ``d_u`` positives, draw
``r ~ U[0, num_items - d_u)`` and map it to the ``r``-th non-positive item,
``item = r + |{j: shifted_j <= r}|`` with ``shifted_j = positives_j - j``.
The count is one ``torch.searchsorted(..., right=True)``: over each slot's
table row in the bucketed sampler (the row, shifted values then the
sentinel ``num_items``, is sorted, so it equals the JAX version's
``sum(row <= r)``), and over int64 flat keys ``user << 31 | shifted_j`` in
the CSR sampler, where ``searchsorted(keys, (user << 31) + r) -
indptr[user]`` equals the JAX version's segmented binary search.  A user
who holds every item has no complement: the samplers return JAX's values,
item ``-1`` from the CSR sampler and ``num_items`` (the sentinel that ends
the row) from the bucketed one, and the engine clamps them before any
gather, but on the bucketed reorder path, which JAX's does not clamp
either.

``pairs_in_csr``: the JAX version runs a segmented binary search over each
user's sorted columns because int32 flat keys overflow.  PyTorch has int64,
so each CSR entry becomes the flat key ``user << 31 | item`` and one
``torch.searchsorted`` answers the whole batch.
"""
import ctypes
import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from collie_tpu_torch.ops.kernels import _build

_ITEM_BITS = 31
SPARES_PER_ROUND = 2
#: elements of one gathered ``[chunk, P_b]`` table block in the count pass
_COUNT_BLOCK_ELEMENTS = 1 << 25
SAMPLE_SOURCE = 'bucketed_sample.cu'
SAMPLE_ABI = 2


def _duplicate_within_row_mask(negatives: torch.Tensor) -> torch.Tensor:
    """Mark duplicated values within each row (all but the first occurrence)."""
    K = negatives.shape[-1]
    eq = negatives[..., :, None] == negatives[..., None, :]      # [..., K, K]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                    device=negatives.device), diagonal=-1)
    return (eq & earlier).any(-1)


def build_complement_tables(csr) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side precompute for complement sampling from a scipy CSR matrix.

    Returns ``(indptr [num_users + 1], shifted_cols [nnz])`` where
    ``shifted_cols[indptr[u] + j] = sorted_positives_of_u[j] - j``.
    """
    csr = csr.tocsr()
    csr.sort_indices()
    indptr = csr.indptr.astype(np.int32)
    cols = csr.indices.astype(np.int32)
    rank_within_row = np.arange(len(cols), dtype=np.int32) - np.repeat(
        indptr[:-1], np.diff(indptr))
    return indptr, cols - rank_within_row


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class BucketedPlan:
    """What the device builder knows before it fills the bucketed tables
    (``plan_bucketed_complement_tables``): tensors on the ids' device, and
    on the host each bucket's width and its user and example counts."""
    keys: torch.Tensor          # sorted ``user << 31 | item``, repeated pairs kept
    first: torch.Tensor         # bool: the first key of its run of equal keys
    rank: torch.Tensor          # each key's rank among its user's distinct items
    counts: torch.Tensor        # int32 [num_users]: distinct items per user
    user_bucket: torch.Tensor   # int64 [num_users]
    user_local: torch.Tensor    # int64 [num_users]: the user's row in its table
    ex_order: torch.Tensor      # canonical index of each example, grouped order
    ex_users: torch.Tensor      # int64: each example's user, grouped order
    sizes: torch.Tensor         # int64: the counts below, on the device
    widths: List[int]
    users_per_bucket: List[int]
    examples_per_bucket: List[int]

    @property
    def table_bytes(self) -> int:
        """Device bytes of the tables, counted from the degrees: every
        user's row at its bucket's width (``select_sampler``'s size)."""
        return 4 * sum(m * w for m, w in zip(self.users_per_bucket, self.widths))


def plan_bucketed_complement_tables(users: torch.Tensor, items: torch.Tensor,
                                    num_users: int, num_items: int,
                                    example_rows: Optional[torch.Tensor] = None,
                                    lane: int = 128) -> BucketedPlan:
    """The device builder's first half, on the ids' device: one sort of the
    pairs' keys (a repeated pair counts once in the degrees and ranks, as
    ``tocsr()`` merges it), the degrees' buckets, one stable sort of the
    examples (``example_rows``, by default ``users``) by ``(bucket, user)``,
    which is the JAX builder's per-bucket stable argsort, and one host
    read of the buckets' user and example counts.  The widths run up to
    ``num_items``, past the largest degree: the extra buckets are empty and
    skipped, as the JAX builder skips empty buckets."""
    device = users.device
    users, items = users.long(), items.long()
    keys = torch.sort((users << _ITEM_BITS) | items).values
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    distinct = torch.cumsum(first, 0)            # distinct keys up to each position
    starts = torch.searchsorted(keys, torch.arange(num_users + 1, device=device) << _ITEM_BITS)
    before = torch.cat([distinct.new_zeros(1), distinct])[starts]   # [num_users + 1]
    counts = before[1:] - before[:-1]
    rank = distinct - 1 - before[keys >> _ITEM_BITS]

    widths = [lane]
    while widths[-1] < num_items:
        widths.append(widths[-1] * 2)
    bounds = torch.arange(len(widths) + 1, device=device) * num_users
    user_bucket = torch.searchsorted(lane << torch.arange(len(widths), device=device), counts)
    user_key, user_order = torch.sort(user_bucket * num_users
                                      + torch.arange(num_users, device=device))
    user_start = torch.searchsorted(user_key, bounds)
    user_local = torch.empty_like(user_order)
    user_local[user_order] = (torch.arange(num_users, device=device)
                              - user_start[user_bucket[user_order]])

    ex_users = users if example_rows is None else example_rows.long()
    ex_key, ex_order = torch.sort(user_bucket[ex_users] * num_users + ex_users, stable=True)
    sizes = torch.cat([user_start.diff(), torch.searchsorted(ex_key, bounds).diff()])
    if device.type == 'cpu':
        host = sizes.tolist()
    else:
        from collie_tpu_torch.training.profiler import annotate
        with annotate('collie.sync'):
            host = sizes.tolist()
    return BucketedPlan(keys, first, rank, counts.to(torch.int32), user_bucket, user_local,
                        ex_order, ex_users[ex_order], sizes, widths, host[:len(widths)],
                        host[len(widths):])


def build_bucketed_complement_tables_torch(users: torch.Tensor, items: torch.Tensor,
                                           num_users: int, num_items: int,
                                           lane: int = 128, chunk: int = 8192,
                                           example_rows: Optional[torch.Tensor] = None,
                                           plan: Optional[BucketedPlan] = None):
    """The tables of the degree-bucketed sampler, on the ids' device (the
    CPU included), from the interaction ids in their COO order
    (``example_rows``: the examples' users, by default ``users``; ``plan``:
    ``plan_bucketed_complement_tables`` of the same arguments, made here
    when None): the arrays of collie_tpu's numpy builder
    (``collie_tpu/ops/device_sampling.py:87``), value by value and dtype by
    dtype.  Users are partitioned into power-of-two
    width buckets (128, 256, ...), each with its own ``[users_in_bucket,
    P_b]`` table of shifted positives padded with ``num_items``; the
    epoch's examples are laid out in a fixed GROUPED order (bucket-major,
    user-sorted within each bucket, each bucket padded to its chunk).

    Returns ``(bucket_specs, row_counts, users_g, pos_of)``:

    * ``bucket_specs`` — tuple of ``(row_idx [n_b_pad], table [m_b, P_b])``
      per bucket with examples; ``row_idx`` is the bucket-local user row of
      each grouped slot (chunk padding points at row 0).
    * ``row_counts [num_users]`` int32 — distinct positives per user.
    * ``users_g [N_g]`` int32 — global user id per grouped slot (pads ->
      user 0).
    * ``pos_of [n_canon]`` int32 — grouped slot of each example.

    The host reads only the plan's bucket counts.  The tables are views
    into one buffer, whose last element takes the writes of repeated pairs
    and of empty buckets' users."""
    device = users.device
    if plan is None:
        plan = plan_bucketed_complement_tables(users, items, num_users, num_items,
                                               example_rows, lane)
    nb = len(plan.widths)
    width_of = lane << torch.arange(nb, device=device)
    users_of, examples_of = plan.sizes[:nb], plan.sizes[nb:]
    size_of = torch.where(examples_of > 0, users_of * width_of, 0)
    start_of = torch.cumsum(size_of, 0) - size_of
    total = sum(m * w for m, w, n in zip(plan.users_per_bucket, plan.widths,
                                         plan.examples_per_bucket) if n)
    key_users = plan.keys >> _ITEM_BITS
    bucket = plan.user_bucket[key_users]
    dest = torch.where(plan.first & (examples_of[bucket] > 0),
                       start_of[bucket] + plan.user_local[key_users] * width_of[bucket]
                       + plan.rank, total)
    flat = torch.full((total + 1,), num_items, dtype=torch.int32, device=device)
    flat[dest] = ((plan.keys & ((1 << _ITEM_BITS) - 1)) - plan.rank).to(torch.int32)

    pads = [-n % min(chunk, _ceil_pow2(n)) if n else 0 for n in plan.examples_per_bucket]
    users_g = torch.zeros(sum(plan.examples_per_bucket) + sum(pads), dtype=torch.int32,
                          device=device)
    pos_of = torch.empty(plan.ex_order.shape[0], dtype=torch.int32, device=device)
    specs = []
    table_at = slot_at = ex_at = 0
    for m, width, n, pad in zip(plan.users_per_bucket, plan.widths,
                                plan.examples_per_bucket, pads):
        if n == 0:
            continue
        ex_users = plan.ex_users[ex_at:ex_at + n]
        pos_of[plan.ex_order[ex_at:ex_at + n]] = torch.arange(
            slot_at, slot_at + n, dtype=torch.int32, device=device)
        users_g[slot_at:slot_at + n] = ex_users
        row_idx = torch.zeros(n + pad, dtype=torch.int32, device=device)
        row_idx[:n] = plan.user_local[ex_users]
        specs.append((row_idx, flat[table_at:table_at + m * width].view(m, width)))
        table_at, slot_at, ex_at = table_at + m * width, slot_at + n + pad, ex_at + n
    return tuple(specs), plan.counts, users_g, pos_of


def count_at_or_below(rows: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``|{j: rows[i, j] <= r[i, w]}|`` as int32 ``[c, width]``, for rows
    sorted in non-decreasing order."""
    return torch.searchsorted(rows, r, right=True).to(torch.int32)


def _count_grouped(r: torch.Tensor, bucket_specs) -> torch.Tensor:
    """Bucket by bucket at each bucket's own width, over contiguous slices
    of ``r`` (``[N_g, width]``), in row blocks that bound the gathered
    ``[rows, P_b]`` table block."""
    outs = []
    off = 0
    for row_idx_b, table_b in bucket_specs:
        nb = int(row_idx_b.shape[0])
        r_b = r[off:off + nb]
        off += nb
        step = max(1, _COUNT_BLOCK_ELEMENTS // int(table_b.shape[1]))
        for start in range(0, nb, step):
            rows = table_b[row_idx_b[start:start + step].long()]     # [c, P_b]
            outs.append(count_at_or_below(rows, r_b[start:start + step].contiguous()))
    return torch.cat(outs, dim=0)


def _check_uniforms(u01: torch.Tensor, users_g: torch.Tensor, width: int) -> None:
    if tuple(u01.shape) != (users_g.shape[0], width):
        raise ValueError(f'u01 must be [{users_g.shape[0]}, {width}], got {tuple(u01.shape)}')


def complement_sample_negatives_bucketed_grouped_plain(
        u01: torch.Tensor,
        users_g: torch.Tensor,
        bucket_specs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        row_counts: torch.Tensor,
        num_items: int,
        num_negative_samples: int,
        dedup_rounds: int = 1) -> torch.Tensor:
    """``complement_sample_negatives_bucketed_grouped`` in torch operations,
    on any device: the CPU's path and the sampler kernel's reference."""
    K = num_negative_samples
    _check_uniforms(u01, users_g, K + SPARES_PER_ROUND * dedup_rounds)
    sizes = torch.clamp(
        (num_items - row_counts[users_g.long()])[:, None].to(torch.int32), min=1)
    r = torch.minimum((u01 * sizes).to(torch.int32), sizes - 1)
    all_draws = r + _count_grouped(r, bucket_specs)                # [N_g, W]
    negatives = all_draws[:, :K]
    for round_idx in range(dedup_rounds):
        spares = all_draws[:, K + round_idx * SPARES_PER_ROUND:
                           K + (round_idx + 1) * SPARES_PER_ROUND]
        dup = _duplicate_within_row_mask(negatives)                # [N_g, K]
        dup_rank = torch.cumsum(dup.to(torch.int32), dim=1) - 1    # 0-based among dups
        subst = torch.where(dup_rank == 0, spares[:, :1], spares[:, 1:2])
        use = dup & (dup_rank < SPARES_PER_ROUND)
        negatives = torch.where(use, subst, negatives)
    return negatives


def _sample_library() -> ctypes.CDLL:
    lib = _build.load(SAMPLE_SOURCE, abi=('collie_bucketed_sample_abi', SAMPLE_ABI))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.collie_bucketed_sample.argtypes = [p, p, p, ll, i, i, i, i, p, p, p, p, p, p]
    lib.collie_bucketed_sample.restype = i
    return lib


def _check_sample(u01: torch.Tensor, users_g: torch.Tensor, bucket_specs,
                  row_counts: torch.Tensor, width: int) -> None:
    """What the sampler kernel takes: float32 uniforms, int32 ids, rows and
    tables, each contiguous, the buckets' slots adding up to ``N_g``, all on
    one CUDA device."""
    _check_uniforms(u01, users_g, width)
    tensors = {'u01': u01, 'users_g': users_g, 'row_counts': row_counts}
    for b, (row_idx, table) in enumerate(bucket_specs):
        tensors[f'row_idx[{b}]'], tensors[f'table[{b}]'] = row_idx, table
    for name, x in tensors.items():
        want = torch.float32 if name == 'u01' else torch.int32
        if x.dtype != want:
            raise TypeError(f'the sampler kernel takes {name} as {want}, got {x.dtype}')
        if x.dim() != (2 if name == 'u01' or name.startswith('table') else 1):
            raise ValueError(f'the sampler kernel takes {name} of another rank, '
                             f'got shape {tuple(x.shape)}')
        if not x.is_contiguous():
            raise ValueError(f'the sampler kernel takes {name} contiguous')
    slots = sum(int(row_idx.shape[0]) for row_idx, _ in bucket_specs)
    if slots != users_g.shape[0]:
        raise ValueError(f'the buckets hold {slots} slots, users_g {users_g.shape[0]}')
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1 or u01.device.type != 'cuda':
        raise ValueError(f'the sampler kernel takes tensors on one CUDA device, got '
                         f'{sorted(map(str, devices))}')


def complement_sample_negatives_bucketed_grouped_cuda(
        u01: torch.Tensor,
        users_g: torch.Tensor,
        bucket_specs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        row_counts: torch.Tensor,
        num_items: int,
        num_negative_samples: int,
        dedup_rounds: int = 1) -> torch.Tensor:
    """Launch the sampler kernel (``csrc/bucketed_sample.cu``) on the
    current stream: the plain version's ``[N_g, K]`` int32, value for
    value, in one launch over every bucket (none for no slot).  Reads
    nothing back from the card; raises on what the kernel does not take
    (``_check_sample``)."""
    K = num_negative_samples
    if K < 1 or dedup_rounds < 0:
        raise ValueError(f'the sampler kernel takes num_negative_samples >= 1 and '
                         f'dedup_rounds >= 0, got {K} and {dedup_rounds}')
    _check_sample(u01, users_g, bucket_specs, row_counts, K + SPARES_PER_ROUND * dedup_rounds)
    device = u01.device
    n_slots = u01.shape[0]
    out = torch.empty((n_slots, K), dtype=torch.int32, device=device)
    if n_slots == 0:
        return out
    nb = len(bucket_specs)
    starts = np.cumsum([0] + [int(row_idx.shape[0]) for row_idx, _ in bucket_specs[:-1]])
    tables = (ctypes.c_longlong * nb)(*[table.data_ptr() for _, table in bucket_specs])
    rows = (ctypes.c_longlong * nb)(*[row_idx.data_ptr() for row_idx, _ in bucket_specs])
    firsts = (ctypes.c_longlong * nb)(*starts.tolist())
    widths = (ctypes.c_int * nb)(*[int(table.shape[1]) for _, table in bucket_specs])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _sample_library().collie_bucketed_sample(
            u01.data_ptr(), users_g.data_ptr(), row_counts.data_ptr(), n_slots, num_items, K,
            dedup_rounds, nb, tables, rows, firsts, widths, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'collie_bucketed_sample launch failed: cudaError_t {err}')
    complement_sample_negatives_bucketed_grouped.launches += 1
    return out


def complement_sample_negatives_bucketed_grouped(
        u01: torch.Tensor,
        users_g: torch.Tensor,
        bucket_specs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
        row_counts: torch.Tensor,
        num_items: int,
        num_negative_samples: int,
        dedup_rounds: int = 1) -> torch.Tensor:
    """The bucketed sampler's core: negatives ``[N_g, K]`` int32 in GROUPED
    order, from iid uniforms ``u01 [N_g, K + 2 * dedup_rounds]`` (float32).

    Each dedup round pre-draws two spare complement values per row in the
    same count pass and puts the i-th within-row duplicate's place to the
    i-th spare; a spare that collides again leaves a residual duplicate.

    CUDA tensors go through the sampler kernel, which raises on what it
    does not take; other tensors through the plain version.
    ``complement_sample_negatives_bucketed_grouped.launches`` counts the
    kernel's launches.
    """
    fn = (complement_sample_negatives_bucketed_grouped_cuda if u01.device.type == 'cuda'
          else complement_sample_negatives_bucketed_grouped_plain)
    return fn(u01, users_g, bucket_specs, row_counts, num_items, num_negative_samples,
              dedup_rounds)


complement_sample_negatives_bucketed_grouped.launches = 0


def complement_sample_negatives_bucketed(
        u01: torch.Tensor,
        idx: torch.Tensor,
        pos_of: torch.Tensor,
        users_g: torch.Tensor,
        bucket_specs,
        row_counts: torch.Tensor,
        num_items: int,
        num_negative_samples: int,
        dedup_rounds: int = 1) -> torch.Tensor:
    """Degree-bucketed complement sampling over a shuffled epoch: the
    grouped sampler, then the one reorder ``negatives[pos_of[idx]]``.
    Positions past the epoch's real examples repeat ``idx[0]``'s negatives."""
    negatives = complement_sample_negatives_bucketed_grouped(
        u01, users_g, bucket_specs, row_counts, num_items,
        num_negative_samples, dedup_rounds=dedup_rounds)
    return negatives[pos_of[idx.long()].long()]


def _check_draws(draws: torch.Tensor, rounds: int, shape, what: str) -> None:
    expected = (rounds,) + tuple(shape)
    if tuple(draws.shape) != expected:
        raise ValueError(f'{what} must be {list(expected)} (one block per round), '
                         f'got {list(draws.shape)}')


def _csr_count(keys: torch.Tensor, indptr: torch.Tensor, users: torch.Tensor,
               r: torch.Tensor) -> torch.Tensor:
    """``|{j in row u: shifted_j <= r}|`` from the flat keys ``user << 31 |
    shifted_j``: rows of ``r`` belong to ``users`` (``[n]``).  ``(u << 31) +
    r`` stays inside user ``u``'s key range for every ``r >= -1``."""
    query = (users.long()[:, None] << _ITEM_BITS) + r.long()
    upto = torch.searchsorted(keys, query.reshape(-1), right=True).reshape(query.shape)
    return (upto - indptr[users.long()].long()[:, None]).to(torch.int32)


def complement_sample_negatives_impl(u01: torch.Tensor,
                                     user_ids: torch.Tensor,
                                     indptr: torch.Tensor,
                                     shifted_cols: torch.Tensor,
                                     num_items: int,
                                     num_negative_samples: int,
                                     dedup_rounds: int = 1,
                                     keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Complement sampling through the CSR tables of
    ``build_complement_tables``: negatives ``user_ids.shape + (K,)`` int32
    from uniforms ``u01 [1 + dedup_rounds, *user_ids.shape, K]``.  Round 0
    draws every position, each dedup round redraws the within-row
    duplicates from its own block of ``u01``; the negatives are those of
    the JAX package's padded sampler too, given the same uniforms.
    ``keys`` (``csr_keys(indptr, shifted_cols)``) may be passed when the
    tables serve many calls."""
    K = num_negative_samples
    shape = tuple(user_ids.shape) + (K,)
    _check_draws(u01, 1 + dedup_rounds, shape, 'u01')
    if keys is None:
        keys = csr_keys(indptr, shifted_cols)
    flat_users = user_ids.reshape(-1).long()
    complement_size = (num_items - (indptr[flat_users + 1] - indptr[flat_users])
                       )[:, None].to(torch.int32)
    flat_u01 = u01.reshape(1 + dedup_rounds, -1, K)

    def draw(u):
        r = torch.minimum((u * complement_size).to(torch.int32), complement_size - 1)
        return r + _csr_count(keys, indptr, flat_users, r)

    negatives = draw(flat_u01[0])
    for round_idx in range(dedup_rounds):
        dup = _duplicate_within_row_mask(negatives)
        negatives = torch.where(dup, draw(flat_u01[1 + round_idx]), negatives)
    return negatives.reshape(shape)


def distinct_complement_sample_negatives_impl(u01: torch.Tensor,
                                              user_ids: torch.Tensor,
                                              indptr: torch.Tensor,
                                              shifted_cols: torch.Tensor,
                                              num_items: int,
                                              num_negative_samples: int,
                                              keys: Optional[torch.Tensor] = None
                                              ) -> torch.Tensor:
    """Complement sampling with K distinct values per row in one pass, from
    ``u01 [2, *user_ids.shape, K]`` (the spacing draws, then the shuffle
    draws): K values from ``[0, M - K)`` (``M`` the user's complement
    size), sorted, plus ``arange(K)``, mapped through the CSR count, then
    each row shuffled by a stable argsort of the second block.  Not used by
    the training engine (the JAX package measured a ~25% MAP@10 loss against
    iid draws)."""
    K = num_negative_samples
    shape = tuple(user_ids.shape) + (K,)
    _check_draws(u01, 2, shape, 'u01')
    if keys is None:
        keys = csr_keys(indptr, shifted_cols)
    flat_users = user_ids.reshape(-1).long()
    complement_size = (num_items - (indptr[flat_users + 1] - indptr[flat_users])
                       )[:, None].to(torch.int32)
    span = torch.clamp(complement_size - K, min=1)
    base = torch.minimum((u01[0].reshape(-1, K) * span).to(torch.int32), span - 1)
    r = torch.sort(base, dim=-1, stable=True).values \
        + torch.arange(K, dtype=torch.int32, device=base.device)
    # degenerate users whose complement is smaller than K
    r = torch.minimum(r, torch.clamp(complement_size - 1, min=0))
    items = r + _csr_count(keys, indptr, flat_users, r)
    order = torch.argsort(u01[1].reshape(-1, K), dim=-1, stable=True)
    return torch.take_along_dim(items, order, dim=-1).reshape(shape)


def contains_pairs(positive_keys: torch.Tensor,
                   user_ids: torch.Tensor,
                   item_ids: torch.Tensor,
                   num_items: int) -> torch.Tensor:
    """Membership test against the sorted flat keys ``user * num_items +
    item`` (in ``positive_keys.dtype``)."""
    key_dtype = positive_keys.dtype
    keys = user_ids.to(key_dtype) * num_items + item_ids.to(key_dtype)
    idx = torch.searchsorted(positive_keys, keys.reshape(-1))
    idx = torch.clamp(idx, max=positive_keys.shape[0] - 1)
    return (positive_keys[idx] == keys.reshape(-1)).reshape(keys.shape)


def sample_negatives_impl(draws: torch.Tensor,
                          user_ids: torch.Tensor,
                          positive_keys: torch.Tensor,
                          num_items: int,
                          num_negative_samples: int,
                          exact: bool = True,
                          max_resample_rounds: int = 8) -> torch.Tensor:
    """The redraw-rounds sampler (the host sampler's semantics on the
    device): item ids ``draws [1 + max_resample_rounds, B, K]`` in ``[0,
    num_items)`` (``[1, B, K]`` when not ``exact``), the first draw then one
    redraw per round of every position that is a positive or a within-row
    duplicate."""
    B = user_ids.shape[0]
    K = num_negative_samples
    _check_draws(draws, 1 + (max_resample_rounds if exact else 0), (B, K), 'draws')
    negatives = draws[0].to(torch.int32)
    if not exact:
        return negatives
    users = user_ids[:, None].expand(B, K)
    for round_idx in range(max_resample_rounds):
        bad = contains_pairs(positive_keys, users, negatives, num_items)
        bad = bad | _duplicate_within_row_mask(negatives)
        negatives = torch.where(bad, draws[1 + round_idx].to(torch.int32), negatives)
    return negatives


# the JAX package's jitted wrappers, under their names
sample_negatives = sample_negatives_impl
complement_sample_negatives = complement_sample_negatives_impl
distinct_complement_sample_negatives = distinct_complement_sample_negatives_impl


def csr_keys(indptr: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Sorted int64 flat keys of a CSR whose rows have sorted columns."""
    rows = torch.repeat_interleave(
        torch.arange(indptr.numel() - 1, device=cols.device),
        (indptr[1:] - indptr[:-1]).long())
    return (rows << _ITEM_BITS) | cols.long()


def keys_contain(keys: torch.Tensor, user_ids: torch.Tensor,
                 item_ids: torch.Tensor) -> torch.Tensor:
    """Bool ``(user, item) in keys`` of the broadcast shape of the ids."""
    user_ids, item_ids = torch.broadcast_tensors(user_ids, item_ids)
    if keys.numel() == 0:
        return torch.zeros(user_ids.shape, dtype=torch.bool, device=user_ids.device)
    query = (user_ids.long() << _ITEM_BITS) | item_ids.long()
    idx = torch.searchsorted(keys, query.reshape(-1)).clamp_(max=keys.numel() - 1)
    return (keys[idx] == query.reshape(-1)).reshape(query.shape)


def pairs_in_csr(indptr: torch.Tensor,
                 cols: torch.Tensor,
                 user_ids: torch.Tensor,
                 item_ids: torch.Tensor) -> torch.Tensor:
    """Membership test ``(user, item) in csr``.  Shapes broadcast:
    ``user_ids [...]`` x ``item_ids [...]`` -> bool of the broadcast shape.
    Each row's columns must be sorted (``csr.sort_indices()``)."""
    return keys_contain(csr_keys(indptr, cols), user_ids, item_ids)
