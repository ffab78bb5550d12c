"""Batched full-catalog evaluation.

Port of ``collie_tpu/evaluate.py`` (single device; the mesh tier is not
ported yet).  Per user block the device work is one ``score_all_items``
matmul followed by the rank-count metrics; the host only slices CSR target
rows.  The JAX version scans the user blocks inside one jitted program; here
the scan is a Python loop over the same blocks.
"""
from typing import Any, Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from collie_tpu_torch.data import Interactions
from collie_tpu_torch.ops import metrics as metrics_lib

# cap on the [block, num_items] score block the fused evaluator holds
_FUSED_EVAL_MAX_ELEMENTS = 512 * 1024 * 1024


def get_preds(model,
              user_ids: Union[np.ndarray, Iterable[int]],
              n_items: int = None,
              device: Optional[str] = None) -> torch.Tensor:
    """``[len(user_ids), num_items]`` score block on the model's device
    (reference ``metrics.py:77-107``).  ``n_items`` / ``device`` are kept for
    API parity; the catalog size and the device come from the model."""
    with torch.no_grad():
        return model.score_all_items(model.params, model._ids(user_ids))


def evaluate_in_batches(
    metric_list: Iterable[Callable],
    test_interactions: Interactions,
    model,
    k: int = 10,
    batch_size: int = 128,
    logger: Optional[Any] = None,
    verbose: bool = True,
) -> Union[float, List[float]]:
    """Implicit evaluation (reference ``metrics.py:285-395``).

    Scores each batch of test users against the full catalog and applies
    every metric, weighting batch scores by user count.  With only the
    built-in ``mapk`` / ``mrr`` / ``auc`` the metrics come from rank counts
    on the device (``_fused_evaluate``); custom callables get the reference's
    ``(targets, user_ids, preds, k)`` call with numpy ``preds``.
    """
    if not isinstance(test_interactions, Interactions):
        raise ValueError(
            '``test_interactions`` must be of type ``Interactions``, not '
            f'{type(test_interactions)}. Try using ``explicit_evaluate_in_batches`` instead.'
        )

    test_users = np.unique(test_interactions.mat.row)
    targets = test_interactions.mat.tocsr()
    if len(test_users) < batch_size:
        batch_size = len(test_users)

    all_scores = _fused_evaluate(metric_list, test_users, targets, model, k, batch_size)
    if all_scores is None:
        accumulators = [0.0] * len(metric_list)
        for start in range(0, len(test_users), batch_size):
            user_range = test_users[start:start + batch_size]
            preds = get_preds(model, user_range).cpu().numpy()
            for metric_ind, metric in enumerate(metric_list):
                score = metric(targets=targets, user_ids=user_range, preds=preds, k=k)
                accumulators[metric_ind] += score * len(user_range)
        all_scores = [acc / len(test_users) for acc in accumulators]

    if logger is not None:
        _log_metrics(model=model, logger=logger, metric_list=metric_list,
                     all_scores=all_scores, verbose=verbose)

    return all_scores[0] if len(all_scores) == 1 else all_scores


def _fused_evaluate(metric_list, test_users, targets, model, k: int,
                    batch_size: int) -> Optional[List[float]]:
    """Built-in ranking metrics from rank counts, user block by user block.

    Per block: ``score_all_items`` and the column-blocked rank counts
    (``metrics_from_positive_ranks``), summed per user on the device.  The
    host uploads each block's padded positive-item lists, never a dense
    ``[users, num_items]`` relevance block.  One host sync per evaluation.
    Returns None for custom metric callables.
    """
    metric_row = {metrics_lib.mapk: 0, metrics_lib.mrr: 1, metrics_lib.auc: 2}
    if not all(m in metric_row for m in metric_list):
        return None
    U = len(test_users)
    num_items = model.hparams['num_items']
    # shrink the user block so the [block, num_items] scores stay under the cap
    batch_size = max(1, min(batch_size, _FUSED_EVAL_MAX_ELEMENTS // num_items))
    device = model.device
    totals = torch.zeros(3, dtype=torch.float32, device=device)
    with torch.no_grad():
        for start in range(0, U, batch_size):
            users = test_users[start:start + batch_size]
            pos_items, pos_mask = metrics_lib.padded_positives(targets, users)
            scores = model.score_all_items(model.params, model._ids(users))
            per_user = metrics_lib.metrics_from_positive_ranks(
                scores, torch.as_tensor(pos_items, device=device),
                torch.as_tensor(pos_mask, device=device), k)          # [3, B]
            totals += per_user.sum(dim=1)
    totals = totals.cpu().numpy()
    return [float(totals[metric_row[m]]) / U for m in metric_list]


def _log_metrics(model, logger, metric_list, all_scores, verbose: bool) -> None:
    """Push metric values to a logger keyed by metric name with
    ``num_epochs_completed`` as the step (reference ``metrics.py:524-543``)."""
    step = model.hparams.get('num_epochs_completed')
    names = [
        getattr(m, '__name__', None) or (m if isinstance(m, str) else type(m).__name__)
        for m in metric_list
    ]
    metrics_dict = dict(zip(names, all_scores))
    if verbose:
        print(f'Logging metrics {metrics_dict} to ``logger``...')
    logger.log_metrics(metrics=metrics_dict, step=step)
