"""Implicit ranking losses (and the explicit mse / mae) as torch functions.

Port of ``collie_tpu/ops/losses.py``: the composite ``(Σl + Σl²) / Σw``
reduction, the "partial credit" ideal score difference from categorical
item metadata, collie's modified BPR (``ideal - sigmoid(pos - neg)``),
hinge, the adaptive variants over the hardest sampled negative (first
maximum on ties, as ``jnp.argmax``), and the modified WARP weight
``log(num_items / tries)`` on the first violation in sample order, dense
(``warp_loss``) and with a sparse backward (``warp_loss_sparse``).
``many_negative_scores`` keeps the reference's ``[num_negative_samples,
batch]`` axis convention.  Gradients come from autograd.
"""
from typing import Any, Callable, Dict, Optional

import torch


def ideal_difference_from_metadata(
    positive_items: torch.Tensor,
    negative_items: torch.Tensor,
    metadata: Optional[Dict[str, torch.Tensor]],
    metadata_weights: Optional[Dict[str, float]],
) -> torch.Tensor:
    """Ideal positive-negative score gap given categorical item metadata:
    1.0 less ``metadata_weights[k]`` for every field ``k`` on which the
    negative item matches the positive item.  Weights must sum to <= 1."""
    weight_sum = sum(metadata_weights.values())
    if weight_sum > 1:
        raise ValueError(f'sum of metadata weights was {weight_sum}, must be <=1')

    positive_items = torch.as_tensor(positive_items)
    negative_items = torch.as_tensor(negative_items)
    match_frac = torch.zeros(positive_items.shape, dtype=torch.float32,
                             device=positive_items.device)
    for key, array in metadata.items():
        array = torch.as_tensor(array, device=positive_items.device).reshape(-1)
        matches = array[positive_items.long()] == array[negative_items.long()]
        match_frac = match_frac + matches.to(torch.float32) * metadata_weights[key]
    return 1.0 - match_frac


def _ideal_difference_or_one(positive_items, negative_items, metadata, metadata_weights):
    if metadata is not None and len(metadata) > 0:
        return ideal_difference_from_metadata(positive_items=positive_items,
                                              negative_items=negative_items,
                                              metadata=metadata,
                                              metadata_weights=metadata_weights)
    return 1.0


def _composite_reduction(loss: torch.Tensor,
                         batch_size: int,
                         sample_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """collie's L1+L2 composite reduction ``(Σl + Σl²) / B``, weighted for
    padded batches: ``(Σlw + Σl²w) / max(Σw, 1)``."""
    if sample_weights is None:
        return (loss.sum() + torch.square(loss).sum()) / batch_size
    w = torch.as_tensor(sample_weights, device=loss.device).to(loss.dtype)
    denom = torch.clamp(w.sum(), min=1.0)
    return ((loss * w).sum() + (torch.square(loss) * w).sum()) / denom


def bpr_loss(positive_scores: torch.Tensor,
             negative_scores: torch.Tensor,
             num_items: Optional[Any] = None,
             positive_items: Optional[torch.Tensor] = None,
             negative_items: Optional[torch.Tensor] = None,
             metadata: Optional[Dict[str, torch.Tensor]] = None,
             metadata_weights: Optional[Dict[str, float]] = None,
             sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """collie's modified BPR: ``ideal_difference - sigmoid(pos - neg)``."""
    ideal_difference = _ideal_difference_or_one(positive_items, negative_items,
                                                metadata, metadata_weights)
    loss = ideal_difference - torch.sigmoid(positive_scores - negative_scores)
    return _composite_reduction(loss, positive_scores.shape[0], sample_weights)


def hinge_loss(positive_scores: torch.Tensor,
               negative_scores: torch.Tensor,
               num_items: Optional[Any] = None,
               positive_items: Optional[torch.Tensor] = None,
               negative_items: Optional[torch.Tensor] = None,
               metadata: Optional[Dict[str, torch.Tensor]] = None,
               metadata_weights: Optional[Dict[str, float]] = None,
               sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pairwise hinge: ``max(0, ideal_difference - (pos - neg))``."""
    ideal_difference = _ideal_difference_or_one(positive_items, negative_items,
                                                metadata, metadata_weights)
    # relu: zero gradient at a zero hinge, as the kernel's ``l > 0`` factor
    loss = torch.relu(ideal_difference - (positive_scores - negative_scores))
    return _composite_reduction(loss, positive_scores.shape[0], sample_weights)


def _select_hardest_negatives(many_negative_scores, positive_items, negative_items):
    """Max over the ``num_negative_samples`` axis (first maximum on ties),
    plus the matching negative-item ids for metadata credit."""
    highest_idx = torch.argmax(many_negative_scores, dim=0)
    batch_range = torch.arange(many_negative_scores.shape[1],
                               device=many_negative_scores.device)
    highest_scores = many_negative_scores[highest_idx, batch_range]
    if negative_items is not None and positive_items is not None:
        negative_items = torch.as_tensor(negative_items)[highest_idx, batch_range]
    return highest_scores, negative_items


def adaptive_bpr_loss(positive_scores: torch.Tensor,
                      many_negative_scores: torch.Tensor,
                      num_items: Optional[Any] = None,
                      positive_items: Optional[torch.Tensor] = None,
                      negative_items: Optional[torch.Tensor] = None,
                      metadata: Optional[Dict[str, torch.Tensor]] = None,
                      metadata_weights: Optional[Dict[str, float]] = None,
                      sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """BPR over the hardest sampled negative."""
    highest, negative_items = _select_hardest_negatives(
        many_negative_scores, positive_items, negative_items)
    return bpr_loss(positive_scores, highest,
                    positive_items=positive_items, negative_items=negative_items,
                    metadata=metadata, metadata_weights=metadata_weights,
                    sample_weights=sample_weights)


def adaptive_hinge_loss(positive_scores: torch.Tensor,
                        many_negative_scores: torch.Tensor,
                        num_items: Optional[Any] = None,
                        positive_items: Optional[torch.Tensor] = None,
                        negative_items: Optional[torch.Tensor] = None,
                        metadata: Optional[Dict[str, torch.Tensor]] = None,
                        metadata_weights: Optional[Dict[str, float]] = None,
                        sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Hinge over the hardest sampled negative."""
    highest, negative_items = _select_hardest_negatives(
        many_negative_scores, positive_items, negative_items)
    return hinge_loss(positive_scores, highest,
                      positive_items=positive_items, negative_items=negative_items,
                      metadata=metadata, metadata_weights=metadata_weights,
                      sample_weights=sample_weights)


def warp_loss(positive_scores: torch.Tensor,
              many_negative_scores: torch.Tensor,
              num_items: int,
              positive_items: Optional[torch.Tensor] = None,
              negative_items: Optional[torch.Tensor] = None,
              metadata: Optional[Dict[str, torch.Tensor]] = None,
              metadata_weights: Optional[Dict[str, float]] = None,
              sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """collie's modified WARP: per row, the first violation
    (``ideal_difference - pos + neg > 0``) among the sampled negatives in
    sample order, weighted by ``log(num_items / tries)``; rows with no
    violation contribute zero."""
    if negative_items is not None and positive_items is not None:
        positive_items = torch.as_tensor(positive_items)[None, :].expand(
            many_negative_scores.shape)

    if metadata is not None and len(metadata) > 0:
        ideal_difference = ideal_difference_from_metadata(
            positive_items=positive_items,
            negative_items=negative_items,
            metadata=metadata,
            metadata_weights=metadata_weights,
        ).T  # [K, B] -> [B, K]
    else:
        ideal_difference = 1.0

    batch_size = positive_scores.shape[0]
    # hinge value per (row, trial): [B, K]
    hinge = ideal_difference - positive_scores[:, None] + many_negative_scores.T

    _, first_violation_value, loss_weights, should_count_loss = \
        _warp_first_violation(hinge, num_items)

    loss = loss_weights * first_violation_value * should_count_loss
    return _composite_reduction(loss, batch_size, sample_weights)


def _warp_first_violation(hinge: torch.Tensor, num_items: int):
    """First-violation scan over ``hinge [B, K]``; returns
    ``(first_violation_idx, first_violation_value, loss_weights,
    should_count_loss)``, each ``[B]``.  Index ``K`` selects the sentinel
    ones-column ("ran out of attempts": value 1.0, counted 0)."""
    batch_size, max_trials = hinge.shape
    ones = torch.ones((batch_size, 1), dtype=hinge.dtype, device=hinge.device)
    hinge_with_ones = torch.cat([hinge, ones], dim=1)

    violations = (hinge_with_ones > 0).to(hinge.dtype)
    reverse_positions = torch.arange(max_trials + 1, 0, -1, dtype=hinge.dtype,
                                     device=hinge.device)
    first_violation_idx = torch.argmax(violations * reverse_positions, dim=1)

    first_violation_value = torch.gather(
        hinge_with_ones, 1, first_violation_idx[:, None])[:, 0]

    number_of_tries = (first_violation_idx + 1).to(hinge.dtype)
    loss_weights = torch.log(num_items / number_of_tries)
    should_count_loss = (number_of_tries <= max_trials).to(hinge.dtype)
    return (first_violation_idx, first_violation_value, loss_weights,
            should_count_loss)


def warp_loss_sparse(positive_scores: torch.Tensor,
                     many_negative_scores_ng: torch.Tensor,
                     rescore_pair: Callable[[torch.Tensor], torch.Tensor],
                     num_items: int,
                     positive_items: Optional[torch.Tensor] = None,
                     negative_items: Optional[torch.Tensor] = None,
                     metadata: Optional[Dict[str, torch.Tensor]] = None,
                     metadata_weights: Optional[Dict[str, float]] = None,
                     sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`warp_loss` with a sparse backward (``collie_tpu/ops/losses.py:
    235-282``): the first-violation scan runs on gradient-free scores
    (``positive_scores [B]``, ``many_negative_scores_ng [K, B]``), and only
    the positive and the selected negative are scored again with gradient,
    through ``rescore_pair(items) -> [2, B]`` (row 0 the positive, row 1 the
    selected negative), so the backward touches ``2B`` rows instead of
    ``K*B``.  The value equals :func:`warp_loss` wherever ``rescore_pair``
    reproduces the selection scores.  Rows with no violation select the
    clamped index ``K - 1`` and are masked by ``should_count``, which zeroes
    their value and gradient."""
    K, B = many_negative_scores_ng.shape
    pos_ng = positive_scores.detach()
    ideal = _ideal_difference_or_one(positive_items, negative_items, metadata,
                                     metadata_weights)
    if torch.is_tensor(ideal):
        ideal_bk = ideal.T if ideal.dim() == 2 else ideal.expand(B, K)
    else:
        ideal_bk = torch.full((B, K), ideal, dtype=pos_ng.dtype, device=pos_ng.device)

    hinge_ng = ideal_bk - pos_ng[:, None] + many_negative_scores_ng.detach().T
    idx, _, loss_weights, should_count = _warp_first_violation(hinge_ng, num_items)

    batch_range = torch.arange(B, device=pos_ng.device)
    safe_idx = torch.clamp(idx, max=K - 1)
    selected_items = torch.as_tensor(negative_items)[safe_idx, batch_range]
    pair = rescore_pair(selected_items)
    value = ideal_bk[batch_range, safe_idx] - pair[0] + pair[1]
    return _composite_reduction(loss_weights * value * should_count, B, sample_weights)


def mse_loss(predictions: torch.Tensor,
             ratings: torch.Tensor,
             sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error for explicit feedback."""
    sq = torch.square(predictions - ratings)
    if sample_weights is None:
        return sq.mean()
    w = sample_weights.to(sq.dtype)
    return (sq * w).sum() / torch.clamp(w.sum(), min=1.0)


def mae_loss(predictions: torch.Tensor,
             ratings: torch.Tensor,
             sample_weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute error for explicit feedback."""
    ab = torch.abs(predictions - ratings)
    if sample_weights is None:
        return ab.mean()
    w = sample_weights.to(ab.dtype)
    return (ab * w).sum() / torch.clamp(w.sum(), min=1.0)


#: loss name -> function, the names ``BasePipeline._configure_loss`` resolves to
LOSSES = {
    'bpr': bpr_loss,
    'hinge': hinge_loss,
    'adaptive_bpr': adaptive_bpr_loss,
    'adaptive_hinge': adaptive_hinge_loss,
    'warp': warp_loss,
    'mse': mse_loss,
    'mae': mae_loss,
}
