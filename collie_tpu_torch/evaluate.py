"""Batched evaluation: full-catalog ranking metrics and explicit errors.

Port of ``collie_tpu/evaluate.py``.  ``evaluate_in_batches``: per user
block the device work is one ``score_all_items`` matmul followed by the
rank-count metrics; the host only slices CSR target rows.  The JAX version
scans the user blocks inside one jitted program; here the scan is a Python
loop over the same blocks.  Under a ``mesh`` (``_sharded_evaluate``) the
users are split over the ``data`` axis and the catalog over ``model``, and
the additive rank counts are summed over ``model``.
``explicit_evaluate_in_batches``: rating errors summed on the device over the
test loader's batches, read once at the end.
"""
import contextlib
from typing import Any, Callable, Iterable, List, Optional, Union

import numpy as np
import torch

from collie_tpu_torch.data import ExplicitInteractions, Interactions, InteractionsDataLoader
from collie_tpu_torch.ops import metrics as metrics_lib
from collie_tpu_torch.ops.kernels.retrieval_kernel import NEG_INF

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
    mesh: Optional[Any] = None,
) -> Union[float, List[float]]:
    """Implicit evaluation (reference ``metrics.py:285-395``).

    Scores each batch of test users against the full catalog and applies
    every metric, weighting batch scores by user count.  With only the
    built-in ``mapk`` / ``mrr`` / ``auc`` the metrics come from rank counts
    on the device (``_fused_evaluate``); custom callables get the reference's
    ``(targets, user_ids, preds, k)`` call with numpy ``preds``.

    ``mesh``: evaluate across a device mesh (``_sharded_evaluate``): users
    split over the ``data`` axis, the catalog over ``model``; every rank
    calls with the same arguments and gets the same values, equal to the
    single-device ones (the rank counts are exact integers).  Custom metric
    callables keep the single-device per-batch path.
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

    # a model holding shards is evaluated on them under its mesh, and
    # gathered whole for the single-device paths
    with model.gathered() if mesh is None else contextlib.nullcontext():
        all_scores = _fused_evaluate(metric_list, test_users, targets, model, k, batch_size,
                                     mesh)
    if all_scores is None:
        accumulators = [0.0] * len(metric_list)
        with model.gathered():
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
                    batch_size: int, mesh=None) -> Optional[List[float]]:
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
    if mesh is not None:
        totals = _sharded_evaluate(model, test_users, targets, k, batch_size, mesh)
        return [float(totals[metric_row[m]]) / U for m in metric_list]
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


def _sharded_eval_param_kinds(model, mesh) -> Optional[dict]:
    """Classify params for the evaluator's localized view
    (``collie_tpu/evaluate.py:197-230``).

    Returns ``{name: 'user' | 'item' | 'replicated'}`` when the model's
    scoring reads params only through user-id / item-id gathers
    (``model._sharded_eval_localizable()``) and every user/item-leading leaf
    row-shards cleanly over the ``model`` axis; None selects the replicated
    path, which scores from the full params.
    """
    from collie_tpu_torch.parallel.mesh import MODEL_AXIS, axis_size
    from collie_tpu_torch.parallel.sharding import param_spec

    if not getattr(model, '_sharded_eval_localizable', lambda: False)():
        return None
    num_users = model.hparams['num_users']
    num_items = model.hparams['num_items']
    n_model = axis_size(mesh, MODEL_AXIS)
    if num_users == num_items:          # leading-dim kind would be ambiguous
        return None
    if num_users % n_model or num_items % n_model:
        return None
    kinds = {}
    for name, shape in model.global_shapes().items():
        value = torch.empty(shape, device='meta')
        lead = shape[0] if shape else None
        if lead == num_users:
            kinds[name] = 'user'
        elif lead == num_items:
            kinds[name] = 'item'
        else:
            kinds[name] = 'replicated'
        if kinds[name] != 'replicated' and MODEL_AXIS not in param_spec(name, value, mesh):
            return None                 # a table leaf would not be sharded
    return kinds


def _sharded_evaluate(model, test_users, targets, k: int, batch_size: int, mesh) -> np.ndarray:
    """Item- and user-sharded rank-count evaluation
    (``collie_tpu/evaluate.py:104-190,262-338``); returns the ``[3]`` metric
    sums over the test users, the same on every rank.

    The batch size is rounded to a multiple of the ``data`` axis and the
    user list padded (pad users masked out).  Per user block each rank
    scores its ``data`` slice of the users against its ``model`` span of
    the catalog, reads its span's share of each positive's score and its
    rank counts, and sums both over ``model``; the per-user metric sums add
    up over ``data`` at the end.  Where ``_sharded_eval_param_kinds``
    allows, each rank reads only its row shards: item leaves are its span,
    user leaves give the block's rows by ``sharded_embedding_lookup`` from
    its shard (communication ``O(batch x dim)``, never ``O(table)``);
    otherwise (hybrids, cold start's bucket stage) it scores
    its span from the full params.  A model that holds its shards on this
    mesh (``BasePipeline.param_layout``) gives its row shards as they are;
    the full-params path gathers them.
    """
    from collie_tpu_torch.parallel.distributed import all_reduce_sum
    from collie_tpu_torch.parallel.embedding import sharded_embedding_lookup
    from collie_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, axis_index, axis_size

    U = len(test_users)
    num_items = model.hparams['num_items']
    n_data, n_model = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    batch_size = max(n_data, (batch_size // n_data) * n_data)
    S = -(-U // batch_size)
    pad = S * batch_size - U
    users_padded = np.concatenate([test_users, np.full(pad, test_users[0])]) \
        if pad else test_users
    pos_items, pos_mask = metrics_lib.padded_positives(targets, users_padded)
    user_mask = np.concatenate([np.ones(U, np.float32), np.zeros(pad, np.float32)])

    device = model.device
    span = -(-num_items // n_model)
    shard = axis_index(mesh, MODEL_AXIS)
    start = shard * span
    item_ids = start + torch.arange(span, device=device)
    valid_items = (item_ids < num_items)[None, :]
    b_local = batch_size // n_data
    first = axis_index(mesh, DATA_AXIS) * b_local

    params = model.params
    layout = model.param_layout()
    held = layout[1] if layout is not None and layout[0] is mesh else None
    kinds = _sharded_eval_param_kinds(model, mesh)
    if kinds is None:
        params = model.whole_params()
    else:
        if layout is not None and held is None:
            params = model.whole_params()
        rows_u = model.hparams['num_users'] // n_model
        u_start = shard * rows_u
        shards = {name: (leaf if held is not None and held[name]
                         else leaf[start:start + span] if kinds[name] == 'item'
                         else leaf[u_start:u_start + rows_u] if kinds[name] == 'user'
                         else leaf)
                  for name, leaf in params.items()}
        local_users = torch.arange(b_local, device=device)
        local_items = torch.arange(span, device=device)

    totals = torch.zeros(3, dtype=torch.float32, device=device)
    with torch.no_grad():
        for s in range(S):
            block = slice(s * batch_size + first, s * batch_size + first + b_local)
            users = model._ids(users_padded[block])
            pos_b = torch.as_tensor(pos_items[block], device=device)
            if kinds is None:
                scores = model.score_item_block(params, users,
                                                item_ids.clamp(max=num_items - 1))
            else:
                # localized view: the block's user rows as [b_local, ...]
                # pseudo-tables (one rank holds each row, so its float32
                # sum is exact in the leaf's dtype), the item leaves this
                # rank's span
                view = {name: (sharded_embedding_lookup(leaf, users, mesh).to(device, leaf.dtype)
                               if kinds[name] == 'user' else leaf)
                        for name, leaf in shards.items()}
                scores = model.score_item_block(view, local_users, local_items)
            scores = torch.where(valid_items, scores, NEG_INF)
            pos_scores = all_reduce_sum(
                metrics_lib.positive_scores_in_block(scores, pos_b, start),
                mesh, MODEL_AXIS).to(device)
            counts = all_reduce_sum(
                torch.stack(metrics_lib.rank_counts_blocked(scores, pos_scores, pos_b, start)),
                mesh, MODEL_AXIS).to(device)
            per_user = metrics_lib.metrics_from_rank_counts(
                counts[0], counts[1], torch.as_tensor(pos_mask[block], device=device), k,
                num_items)                                       # [3, b_local]
            totals += (per_user * torch.as_tensor(user_mask[block], device=device)).sum(dim=1)
    return all_reduce_sum(totals, mesh, DATA_AXIS).cpu().numpy()


def explicit_evaluate_in_batches(
    metric_list: Iterable[Union[str, Callable]],
    test_interactions: ExplicitInteractions,
    model,
    logger: Optional[Any] = None,
    verbose: bool = True,
    **kwargs,
) -> Union[float, List[float]]:
    """Explicit evaluation (reference ``metrics.py:398-502``).

    Scores the valid rows of each batch of an ``InteractionsDataLoader``
    over ``test_interactions`` (``kwargs`` go to the loader).  Accepted
    metrics:

    * the strings ``'mse'`` / ``'mae'``: squared and absolute errors summed
      on the device, read once after the last batch;
    * stateful metric objects with the torchmetrics protocol:
      ``update(preds, ratings)`` per batch with tensors on the model's
      device, ``compute()`` at the end, and (if present) ``reset()`` always
      called in a ``finally``;
    * plain callables ``(preds, ratings) -> float``: they get numpy arrays of
      every prediction and rating, gathered from the device once at the end.
    """
    if not isinstance(test_interactions, ExplicitInteractions):
        raise ValueError(
            '``test_interactions`` must be of type ``ExplicitInteractions``, not '
            f'{type(test_interactions)}. Try using ``evaluate_in_batches`` instead.'
        )

    def _is_stateful(metric):
        return hasattr(metric, 'update') and hasattr(metric, 'compute')

    loader = InteractionsDataLoader(interactions=test_interactions, **kwargs)
    device = model.device
    params = model.whole_params()
    error_sums = torch.zeros(2, dtype=torch.float64, device=device)   # squared, absolute
    count = 0
    custom_preds: List[torch.Tensor] = []
    custom_ratings: List[torch.Tensor] = []
    needs_raw = any(callable(m) and not _is_stateful(m) for m in metric_list)
    stateful = [m for m in metric_list if _is_stateful(m)]

    try:
        with torch.no_grad():
            for batch in loader:
                # the pad rows are masked on the host: no device-side select
                valid = batch['mask'].astype(bool)
                preds = model.score(params, model._ids(batch['users'][valid]),
                                    model._ids(batch['items'][valid]))
                ratings = torch.as_tensor(batch['ratings'][valid], device=device)
                err = preds - ratings
                error_sums += torch.stack([err.square().sum(dtype=torch.float64),
                                           err.abs().sum(dtype=torch.float64)])
                count += len(ratings)
                for metric in stateful:
                    metric.update(preds, ratings)
                if needs_raw:
                    custom_preds.append(preds)
                    custom_ratings.append(ratings)
        sq_sum, abs_sum = error_sums.tolist()
        if needs_raw:
            raw_preds = torch.cat(custom_preds).cpu().numpy()
            raw_ratings = torch.cat(custom_ratings).cpu().numpy()

        all_scores = []
        for metric in metric_list:
            if metric == 'mse':
                all_scores.append(sq_sum / count)
            elif metric == 'mae':
                all_scores.append(abs_sum / count)
            elif _is_stateful(metric):
                all_scores.append(float(metric.compute()))
            elif callable(metric):
                all_scores.append(float(metric(raw_preds, raw_ratings)))
            else:
                raise ValueError(f'Unrecognized explicit metric: {metric!r}')
    finally:
        for metric in stateful:
            reset = getattr(metric, 'reset', None)
            if callable(reset):
                reset()

    if logger is not None:
        _log_metrics(model=model, logger=logger, metric_list=metric_list,
                     all_scores=all_scores, verbose=verbose)

    return all_scores[0] if len(all_scores) == 1 else all_scores


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
