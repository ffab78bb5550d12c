"""Ranking metrics computed on the device from full-catalog score blocks.

Port of ``collie_tpu/ops/metrics.py`` (reference ``collie/metrics.py``:
``mapk`` at ``:144``, ``mrr`` at ``:201``, ``auc`` at ``:243``).  Two layers:

* ``*_from_scores`` over a ``[batch_users, num_items]`` score block and a
  dense 0/1 relevance block, and the rank-count path
  (``positive_scores_in_block`` -> ``rank_counts_in_block`` ->
  ``metrics_from_rank_counts``) that the fused evaluator uses;
* host wrappers ``mapk`` / ``mrr`` / ``auc`` with the reference call signature
  ``(targets: csr_matrix, user_ids, preds, k)``.

XLA fuses the JAX version's ``[B, D_pos, T]`` rank-count compares away;
PyTorch materializes them, which at B=256 users, a few hundred positives and
2M items would be tens of GB.  ``metrics_from_positive_ranks`` therefore
splits the item axis into column blocks and sums the counts over them: the
counts are additive over any partition of the catalog, so the result is
identical.
"""
from typing import Union

import numpy as np
import torch
from scipy.sparse import csr_matrix

from collie_tpu_torch.ops.kernels.retrieval_kernel import stable_topk

#: element budget of one ``[B, D_pos, T_block]`` compare block (bool)
RANK_COUNT_BLOCK_ELEMENTS = 1 << 27


def mapk_from_scores(scores: torch.Tensor,
                     relevance: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Per-user AP@k by the reference's formula (``metrics.py:167-198``):
    topk -> binary hits -> ``hits * cumsum(hits) / rank`` summed, divided by
    ``min(k, per-user positives)``; users with no positives give 0."""
    _, topk_idx = stable_topk(scores, k)
    hits = torch.gather(relevance, 1, topk_idx).float()
    weights = 1.0 / torch.arange(1, k + 1, dtype=torch.float32, device=scores.device)
    numerator = (hits * torch.cumsum(hits, dim=1) * weights).sum(dim=1)
    nnz = relevance.sum(dim=1)
    denominator = torch.clamp(nnz, max=float(k))
    return torch.where(denominator > 0, numerator / denominator,
                       torch.zeros_like(numerator))


def mrr_from_scores(scores: torch.Tensor,
                    relevance: torch.Tensor) -> torch.Tensor:
    """Reciprocal rank of each user's best-scoring relevant item: 1 + the
    number of items scored strictly higher (reference ``metrics.py:224-240``)."""
    rel = relevance > 0
    neg_inf = torch.finfo(scores.dtype).min
    best_rel_score = torch.where(rel, scores, torch.full_like(scores, neg_inf)) \
        .max(dim=1, keepdim=True).values
    rank = 1 + (scores > best_rel_score).sum(dim=1)
    has_rel = rel.any(dim=1)
    return torch.where(has_rel, 1.0 / rank.float(), torch.zeros_like(rank, dtype=torch.float32))


def auc_from_scores(scores: torch.Tensor,
                    relevance: torch.Tensor) -> torch.Tensor:
    """Per-user ROC AUC by the Mann-Whitney rank statistic
    ``(sum of positive ranks - P(P+1)/2) / (P * N)``, ranks from a stable
    ascending argsort; degenerate users give 0.5."""
    rel = (relevance > 0).float()
    order = torch.argsort(scores, dim=1, stable=True)
    ranks = torch.empty_like(order, dtype=torch.int32)
    steps = torch.arange(1, order.shape[1] + 1, dtype=torch.int32, device=scores.device)
    ranks.scatter_(1, order, steps.expand_as(order).contiguous())
    num_pos = rel.sum(dim=1)
    num_neg = rel.shape[1] - num_pos
    rank_sum = (ranks.float() * rel).sum(dim=1)
    denom = num_pos * num_neg
    auc = (rank_sum - num_pos * (num_pos + 1) / 2) / torch.clamp(denom, min=1.0)
    return torch.where(denom > 0, auc, torch.full_like(auc, 0.5))


def _dense_relevance_block(targets: csr_matrix,
                           user_ids: np.ndarray) -> np.ndarray:
    """Host: slice csr rows for a user batch into a dense 0/1 block."""
    block = targets[np.asarray(user_ids)].toarray()
    return (block > 0).astype(np.float32)


def padded_positives(targets: csr_matrix, user_ids: np.ndarray,
                     max_degree: int = None):
    """Host: per-user positive item lists padded to a fixed width.

    Returns ``(pos_items [U, D] int32, pos_mask [U, D] float32)``, the compact
    per-user form the rank-count metrics consume.
    """
    rows = targets[np.asarray(user_ids)]
    degrees = np.diff(rows.indptr)
    D = int(max_degree if max_degree is not None else max(int(degrees.max()), 1))
    U = len(user_ids)
    pos = np.zeros((U, D), dtype=np.int32)
    mask = np.zeros((U, D), dtype=np.float32)
    for i in range(U):
        d = min(int(degrees[i]), D)
        cols = rows.indices[rows.indptr[i]:rows.indptr[i] + d]
        pos[i, :d] = cols
        mask[i, :d] = 1.0
    return pos, mask


def positive_scores_in_block(scores: torch.Tensor,
                             pos_items: torch.Tensor,
                             col_offset: int = 0) -> torch.Tensor:
    """Each positive's own score, read from the block that holds its column.

    ``scores [B, T]`` covers item columns ``[col_offset, col_offset + T)``;
    ``pos_items [B, D]`` are global ids.  Positives outside the block give 0,
    so summing over a partition of the catalog yields every true score.
    Out-of-block ids are clamped before the gather (an out-of-range index is
    a device-side assert on CUDA).
    """
    local = pos_items.long() - col_offset
    in_block = (local >= 0) & (local < scores.shape[1])
    safe = local.clamp(0, scores.shape[1] - 1)
    gathered = torch.gather(scores, 1, safe)
    return torch.where(in_block, gathered, torch.zeros_like(gathered))


def rank_counts_in_block(scores: torch.Tensor,
                         pos_scores: torch.Tensor,
                         pos_items: torch.Tensor,
                         col_offset: int = 0):
    """Comparison counts that fix each positive's rank.

    ``scores [B, T]`` is a block of item columns ``[col_offset,
    col_offset + T)``; ``pos_scores [B, D]`` the positives' global scores and
    ``pos_items [B, D]`` their global ids.  Returns ``(greater, eq_after)
    [B, D] float32``: items in the block scored strictly above the positive,
    and items tied with it at a larger column index (a stable ascending
    argsort's tie-break).  Counts add up over item blocks:
    ``desc = greater + eq_after + 1`` and ``asc = num_items - greater - eq_after``.
    """
    cols = col_offset + torch.arange(scores.shape[1], device=scores.device)
    block = scores[:, None, :]                       # [B, 1, T]
    pos = pos_scores[:, :, None]                     # [B, D, 1]
    greater = (block > pos).sum(dim=-1).float()
    eq_after = ((block == pos) & (cols[None, None, :] > pos_items.long()[:, :, None])
                ).sum(dim=-1).float()
    return greater, eq_after


def metrics_from_rank_counts(greater: torch.Tensor,
                             eq_after: torch.Tensor,
                             pos_mask: torch.Tensor,
                             k: int,
                             num_items: int) -> torch.Tensor:
    """All three ranking metrics from each positive's comparison counts:
    AUC from the ascending rank sum, MRR as 1 / the best descending rank, and
    MAP@k as the sum over positives ranked ``r <= k`` of (positives ranked
    ``<= r``) / r over ``min(k, degree)``.  Returns ``[3, batch]`` rows
    ``(ap@k, reciprocal rank, auc)``."""
    pos_desc = greater + eq_after + 1.0
    pos_asc = num_items - greater - eq_after
    big = torch.tensor(float(num_items + 1), dtype=torch.float32, device=greater.device)
    pos_desc_masked = torch.where(pos_mask > 0, pos_desc, big)
    zero = torch.zeros((), dtype=torch.float32, device=greater.device)

    degree = pos_mask.sum(dim=1)
    num_neg = num_items - degree

    rank_sum = (pos_asc * pos_mask).sum(dim=1)
    denom = degree * num_neg
    auc_vec = torch.where(denom > 0,
                          (rank_sum - degree * (degree + 1) / 2) / torch.clamp(denom, min=1.0),
                          zero + 0.5)

    best = pos_desc_masked.min(dim=1).values
    rr_vec = torch.where(degree > 0, 1.0 / best, zero)

    sorted_desc = torch.sort(pos_desc_masked, dim=1).values
    j = torch.arange(1, sorted_desc.shape[1] + 1, dtype=torch.float32,
                     device=greater.device)[None, :]
    contrib = torch.where(sorted_desc <= k, j / sorted_desc, zero)
    ap_vec = torch.where(degree > 0,
                         contrib.sum(dim=1) / torch.clamp(torch.clamp(degree, min=1.0),
                                                          max=float(k)),
                         zero)
    return torch.stack([ap_vec, rr_vec, auc_vec])


def rank_counts_blocked(scores: torch.Tensor,
                        pos_scores: torch.Tensor,
                        pos_items: torch.Tensor,
                        col_offset: int = 0,
                        block_elements: int = RANK_COUNT_BLOCK_ELEMENTS):
    """``rank_counts_in_block`` of a ``[B, T]`` block of item columns
    ``[col_offset, col_offset + T)``, summed over column blocks of at most
    ``block_elements`` compares (the counts are additive, so the result is
    identical)."""
    width = max(1, block_elements // max(1, scores.shape[0] * pos_items.shape[1]))
    greater = torch.zeros(pos_items.shape, dtype=torch.float32, device=scores.device)
    eq_after = torch.zeros_like(greater)
    for start in range(0, scores.shape[1], width):
        g, e = rank_counts_in_block(scores[:, start:start + width], pos_scores,
                                    pos_items, col_offset + start)
        greater += g
        eq_after += e
    return greater, eq_after


def metrics_from_positive_ranks(scores: torch.Tensor,
                                pos_items: torch.Tensor,
                                pos_mask: torch.Tensor,
                                k: int,
                                block_elements: int = RANK_COUNT_BLOCK_ELEMENTS
                                ) -> torch.Tensor:
    """All three ranking metrics from each user's positive-item ranks, with
    the rank counts summed over column blocks of at most ``block_elements``
    compares.  Returns ``[3, batch]`` rows ``(ap@k, reciprocal rank, auc)``."""
    pos_scores = positive_scores_in_block(scores, pos_items)
    greater, eq_after = rank_counts_blocked(scores, pos_scores, pos_items,
                                            block_elements=block_elements)
    return metrics_from_rank_counts(greater, eq_after, pos_mask, k, scores.shape[1])


def _as_score_matrix(preds) -> torch.Tensor:
    if isinstance(preds, torch.Tensor):
        return preds.float()
    return torch.as_tensor(np.asarray(preds, dtype=np.float32))


def mapk(targets: csr_matrix,
         user_ids: Union[np.ndarray, torch.Tensor],
         preds: Union[np.ndarray, torch.Tensor],
         k: int = 10) -> float:
    """Mean average precision at k (reference ``metrics.py:144-198``)."""
    preds = _as_score_matrix(preds)
    if k > preds.shape[1]:
        raise ValueError(
            f'Ensure ``k`` ({k}) is less than the number of items ({preds.shape[1]})'
        )
    relevance = torch.as_tensor(_dense_relevance_block(targets, user_ids),
                                device=preds.device)
    return float(mapk_from_scores(preds, relevance, k).mean())


def mrr(targets: csr_matrix,
        user_ids: Union[np.ndarray, torch.Tensor],
        preds: Union[np.ndarray, torch.Tensor],
        k: int = None) -> float:
    """Mean reciprocal rank (reference ``metrics.py:201-240``); ``k`` ignored."""
    preds = _as_score_matrix(preds)
    relevance = torch.as_tensor(_dense_relevance_block(targets, user_ids),
                                device=preds.device)
    return float(mrr_from_scores(preds, relevance).mean())


def auc(targets: csr_matrix,
        user_ids: Union[np.ndarray, torch.Tensor],
        preds: Union[np.ndarray, torch.Tensor],
        k: int = None) -> float:
    """Mean per-user ROC AUC (reference ``metrics.py:243-282``); ``k`` ignored."""
    preds = _as_score_matrix(preds)
    relevance = torch.as_tensor(_dense_relevance_block(targets, user_ids),
                                device=preds.device)
    return float(auc_from_scores(preds, relevance).mean())
