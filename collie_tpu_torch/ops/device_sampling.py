"""On-device negative sampling and membership tests against interaction CSRs.

Port of ``collie_tpu/ops/device_sampling.py``: the degree-bucketed
complement sampler the training engine uses (host-side table builders
``build_bucketed_complement_tables`` / ``bucketed_table_bytes``, copied
bit-equal from ``:87-196``; the grouped sampler of ``:237-325`` with its
spare-based dedup; the reorder wrapper of ``:198``) and ``pairs_in_csr``
(``:541``).  The padded and CSR samplers (``:339``, ``:411``), which the JAX
engine takes only above a 1 GB table budget, are not ported yet.

Complement sampling: for user ``u`` with ``d_u`` positives, draw
``r ~ U[0, num_items - d_u)`` and map it to the ``r``-th non-positive item,
``item = r + |{j: shifted_j <= r}|`` with ``shifted_j = positives_j - j``.
The count is one ``torch.searchsorted(..., right=True)`` over each slot's
table row: the row (shifted values, then the sentinel ``num_items``) is
sorted, so it equals the JAX version's ``sum(row <= r)``, padding included.

``pairs_in_csr``: the JAX version runs a segmented binary search over each
user's sorted columns because int32 flat keys overflow.  PyTorch has int64,
so each CSR entry becomes the flat key ``user << 31 | item`` and one
``torch.searchsorted`` answers the whole batch.
"""
from typing import Sequence, Tuple

import numpy as np
import torch

_ITEM_BITS = 31
SPARES_PER_ROUND = 2
#: elements of one gathered ``[chunk, P_b]`` table block in the count pass
_COUNT_BLOCK_ELEMENTS = 1 << 25


def _duplicate_within_row_mask(negatives: torch.Tensor) -> torch.Tensor:
    """Mark duplicated values within each row (all but the first occurrence)."""
    K = negatives.shape[-1]
    eq = negatives[..., :, None] == negatives[..., None, :]      # [..., K, K]
    earlier = torch.tril(torch.ones((K, K), dtype=torch.bool,
                                    device=negatives.device), diagonal=-1)
    return (eq & earlier).any(-1)


def build_bucketed_complement_tables(csr, example_rows, lane: int = 128,
                                     chunk: int = 8192):
    """Host-side precompute for the degree-bucketed gather-free sampler.

    Users are partitioned into power-of-two width buckets (128, 256, ...),
    each with its own ``[users_in_bucket, P_b]`` table of shifted positives
    padded with ``num_items``; the epoch's examples are laid out in a fixed
    GROUPED order (bucket-major, user-sorted within each bucket, each bucket
    padded to its chunk).

    Returns ``(bucket_specs, row_counts, users_g, pos_of)`` as numpy arrays:

    * ``bucket_specs`` — tuple of ``(row_idx [n_b_pad], table [m_b, P_b])``
      per nonempty bucket; ``row_idx`` is the bucket-local user row of each
      grouped slot (chunk padding points at row 0).
    * ``row_counts [num_users]`` — positives per user.
    * ``users_g [N_g]`` — global user id per grouped slot (pads -> user 0).
    * ``pos_of [n_canon]`` — grouped slot of each canonical example.
    """
    csr = csr.tocsr()
    csr.sort_indices()
    num_users, num_items = csr.shape
    indptr = csr.indptr.astype(np.int64)
    counts = np.diff(indptr).astype(np.int32)
    cols = csr.indices.astype(np.int32)
    rank = np.arange(len(cols), dtype=np.int32) - np.repeat(
        indptr[:-1], counts).astype(np.int32)
    shifted = cols - rank

    max_len = int(counts.max()) if num_users else 0
    widths = []
    w = lane
    while True:
        widths.append(w)
        if w >= max(max_len, 1):
            break
        w *= 2
    user_bucket = np.searchsorted(np.asarray(widths), counts)  # deg<=P_b
    example_rows = np.asarray(example_rows, dtype=np.int64)
    n_canon = len(example_rows)
    ex_bucket = user_bucket[example_rows]

    specs = []
    user_local = np.zeros(num_users, dtype=np.int64)
    pos_of = np.zeros(n_canon, dtype=np.int32)
    users_g_parts = []
    offset = 0
    for b, P in enumerate(widths):
        users_b = np.where(user_bucket == b)[0]
        ex_b = np.where(ex_bucket == b)[0].astype(np.int64)
        if len(users_b) == 0 or len(ex_b) == 0:
            continue
        user_local[users_b] = np.arange(len(users_b))
        table = np.full((len(users_b), P), num_items, dtype=np.int32)
        lengths = counts[users_b].astype(np.int64)
        total = int(lengths.sum())
        rows_rep = np.repeat(np.arange(len(users_b)), lengths)
        pos = np.arange(total) - np.repeat(np.cumsum(lengths) - lengths,
                                           lengths)
        src = np.repeat(indptr[users_b], lengths) + pos
        table[rows_rep, pos] = shifted[src]
        ex_b = ex_b[np.argsort(example_rows[ex_b], kind='stable')]
        users_of_b = example_rows[ex_b]
        row_b = user_local[users_of_b].astype(np.int32)
        pad = -len(ex_b) % min(chunk, _ceil_pow2(len(ex_b)))
        if pad:
            row_b = np.concatenate([row_b, np.zeros(pad, np.int32)])
            users_of_b = np.concatenate(
                [users_of_b, np.zeros(pad, np.int64)])
        pos_of[ex_b] = offset + np.arange(len(ex_b), dtype=np.int32)
        users_g_parts.append(users_of_b.astype(np.int32))
        offset += len(row_b)
        specs.append((row_b, table))
    users_g = (np.concatenate(users_g_parts) if users_g_parts
               else np.zeros(0, np.int32))
    return specs, counts, users_g, pos_of


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def bucketed_table_bytes(csr, lane: int = 128) -> int:
    """Device bytes the bucketed sampler's tables would occupy."""
    csr = csr.tocsr()
    counts = np.diff(csr.indptr)
    if len(counts) == 0:
        return 0
    widths = lane * (2 ** np.ceil(np.log2(np.maximum(counts, 1) / lane))
                     .clip(min=0)).astype(np.int64)
    return int(widths.sum()) * 4


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
    """
    K = num_negative_samples
    W = K + SPARES_PER_ROUND * dedup_rounds
    if tuple(u01.shape) != (users_g.shape[0], W):
        raise ValueError(f'u01 must be [{users_g.shape[0]}, {W}], got {tuple(u01.shape)}')
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
