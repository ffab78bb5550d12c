"""Train / validation / test splits over ``Interactions``.

Rebuild of the reference's ``collie/cross_validation.py`` (``random_split`` at
``:51``, ``stratified_split`` at ``:139``).  The reference stratifies with a
per-user ``sklearn.train_test_split`` fanned out over ``joblib.Parallel``
(``:250-269``); here the whole stratified split is a single vectorized numpy
pass (random within-user order via one permutation + stable sort by user,
per-user test counts via segment arithmetic), preserving the reference's
guarantees: every user appears in every split, single-interaction users raise
unless ``force_split=True`` (in which case they land in train).
"""
from typing import Optional, Tuple

import numpy as np
from scipy.sparse import coo_matrix

from collie_tpu_torch.data.interactions import BaseInteractions, ExplicitInteractions, \
    Interactions
from collie_tpu_torch.utils import get_random_seed


def _validate_val_p_and_test_p(val_p: float, test_p: float) -> None:
    validate_and_test_p = val_p + test_p
    if val_p >= 1 or val_p < 0 or test_p >= 1 or test_p <= 0 or validate_and_test_p >= 1:
        raise ValueError(
            'Splitting requires ``0 <= val_p < 1``, ``0 < test_p < 1`` and '
            '``val_p + test_p < 1``.'
        )


def _subset_interactions(interactions: BaseInteractions,
                         idxs: np.ndarray) -> BaseInteractions:
    """Rebuild an ``Interactions`` subset with all checks disabled
    (reference ``cross_validation.py:18-48``)."""
    idxs = np.asarray(idxs)
    coo_mat = coo_matrix(
        (interactions.mat.data[idxs], (interactions.mat.row[idxs], interactions.mat.col[idxs])),
        shape=(interactions.num_users, interactions.num_items),
    )
    if isinstance(interactions, Interactions):
        return Interactions(
            mat=coo_mat,
            num_negative_samples=interactions.num_negative_samples,
            allow_missing_ids=True,
            remove_duplicate_user_item_pairs=False,
            num_users=interactions.num_users,
            num_items=interactions.num_items,
            check_num_negative_samples_is_valid=False,
            max_number_of_samples_to_consider=interactions.max_number_of_samples_to_consider,
            seed=interactions.seed,
        )
    return ExplicitInteractions(
        mat=coo_mat,
        allow_missing_ids=True,
        remove_duplicate_user_item_pairs=False,
        num_users=interactions.num_users,
        num_items=interactions.num_items,
    )


def random_split(interactions: BaseInteractions,
                 val_p: float = 0.0,
                 test_p: float = 0.2,
                 processes: Optional[int] = None,
                 seed: Optional[int] = None) -> Tuple[BaseInteractions, ...]:
    """Random proportional split (reference ``cross_validation.py:51-136``).

    Does NOT guarantee every user appears in every split.  Returns
    ``(train, test)``, or ``(train, validate, test)`` when ``val_p > 0``.
    ``processes`` is ignored (API compatibility).
    """
    _validate_val_p_and_test_p(val_p=val_p, test_p=test_p)
    if seed is None:
        seed = get_random_seed()

    rng = np.random.default_rng(seed)
    n = len(interactions)
    shuffled = rng.permutation(n)

    validate_cutoff = int((1.0 - val_p - test_p) * n)
    test_cutoff = int((1.0 - test_p) * n)

    train = _subset_interactions(interactions, shuffled[:validate_cutoff])
    test = _subset_interactions(interactions, shuffled[test_cutoff:])
    if val_p > 0:
        validate = _subset_interactions(interactions, shuffled[validate_cutoff:test_cutoff])
        return train, validate, test
    return train, test


def stratified_split(interactions: BaseInteractions,
                     val_p: float = 0.0,
                     test_p: float = 0.2,
                     processes: Optional[int] = None,
                     seed: Optional[int] = None,
                     force_split: bool = False) -> Tuple[BaseInteractions, ...]:
    """Per-user stratified split (reference ``cross_validation.py:139-306``).

    Every user with enough interactions appears in every returned split.  The
    validation split, as in the reference (``:222-229``), is a second
    stratified pass over the training set.  ``processes`` is ignored — the
    split is a single vectorized pass rather than a joblib fan-out.
    """
    _validate_val_p_and_test_p(val_p=val_p, test_p=test_p)
    if seed is None:
        seed = get_random_seed()

    train, test = _stratified_split(interactions, test_p=test_p, seed=seed,
                                    force_split=force_split)
    if val_p > 0:
        train, validate = _stratified_split(train, test_p=val_p / (1 - test_p),
                                            seed=seed + 1, force_split=force_split)
        return train, validate, test
    return train, test


def _stratified_split(interactions: BaseInteractions,
                      test_p: float,
                      seed: int,
                      force_split: bool) -> Tuple[BaseInteractions, BaseInteractions]:
    users = interactions.mat.row
    n = len(users)
    rng = np.random.default_rng(seed)

    # random within-user order: random priorities, then stable sort by user
    priorities = rng.random(n)
    order = np.lexsort((priorities, users))
    sorted_users = users[order]

    # segment boundaries per user present in the data
    boundaries = np.flatnonzero(np.diff(sorted_users)) + 1
    seg_starts = np.concatenate([[0], boundaries])
    seg_ends = np.concatenate([boundaries, [n]])
    seg_sizes = seg_ends - seg_starts

    if (seg_sizes == 1).any() and not force_split:
        raise ValueError(
            'Unable to stratify split on users - the ``interactions`` object contains users'
            ' with a single interaction. Either set ``force_split = True`` to put all users'
            ' with a single interaction in the training set or run'
            ' ``collie_tpu.utils.remove_users_with_fewer_than_n_interactions`` first.'
        )

    # per-user test count: ceil(n_u * test_p), clamped so train keeps >= 1 row
    # (sklearn.train_test_split semantics the reference relies on)
    n_test = np.ceil(seg_sizes * test_p).astype(np.int64)
    n_test = np.minimum(n_test, seg_sizes - 1)  # users with 1 interaction -> 0 test rows

    # the last ``n_test[u]`` entries of each user's randomly-ordered segment go to test
    positions = np.arange(n) - np.repeat(seg_starts, seg_sizes)
    is_test_sorted = positions >= np.repeat(seg_sizes - n_test, seg_sizes)
    test_idxs = order[is_test_sorted]
    train_idxs = order[~is_test_sorted]

    return (_subset_interactions(interactions, train_idxs),
            _subset_interactions(interactions, test_idxs))
