"""Interaction datasets over sparse user x item matrices.

Numpy copy of ``collie_tpu.data.interactions`` (reference
``collie/interactions/datasets.py``: ``BaseInteractions`` at ``:17``,
``Interactions`` at ``:196``, ``ExplicitInteractions`` at ``:448``).  The
out-of-core HDF5 tier is not ported yet.

Key architectural shift vs the reference: the reference performs per-row
rejection sampling of negatives inside ``Dataset.__getitem__``
(``datasets.py:390-445``) — a Python hot loop.  Here the datasets only hold
data + membership structures; sampling is fully vectorized in
``collie_tpu_torch.data.sampling`` and driven per-batch by the loaders, producing
fixed-shape numpy batches.
"""
import warnings
from typing import Iterable, Optional, Tuple, Union

import numpy as np
from scipy.sparse import coo_matrix

from collie_tpu_torch.utils import _create_sparse_ratings_matrix_helper, _infer_num_if_needed, \
    get_random_seed


def _check_array_contains_all_integers(array: np.ndarray, array_max_value: int,
                                       array_name: str) -> None:
    """ID-contiguity check: every integer in ``[0, array_max_value)`` must appear
    (reference: ``datasets.py:736-744``)."""
    present = np.zeros(array_max_value, dtype=bool)
    present[np.asarray(array, dtype=np.int64)] = True
    if not present.all():
        raise ValueError(
            f'``{array_name}`` must contain every integer in [0, {array_max_value}). '
            'Pass ``allow_missing_ids=True`` to skip this check.'
        )


class BaseInteractions:
    """Abstract dataset wrapping a scipy COO user x item ratings matrix.

    Mirrors ``BaseInteractions`` (reference ``datasets.py:17-193``): builds from
    ``mat`` or from ``users``/``items``/``ratings`` arrays, infers
    ``num_users``/``num_items`` as ``max + 1``, validates ID contiguity unless
    ``allow_missing_ids``, and de-duplicates repeated ``(user, item)`` pairs
    (keeping the last value, same as the reference's DOK round-trip at
    ``datasets.py:136-145``).
    """

    def __init__(self,
                 mat: Optional[Union[coo_matrix, np.ndarray]] = None,
                 users: Optional[Iterable[int]] = None,
                 items: Optional[Iterable[int]] = None,
                 ratings: Optional[Iterable[float]] = None,
                 allow_missing_ids: bool = False,
                 remove_duplicate_user_item_pairs: bool = True,
                 num_users: Union[int, str] = 'infer',
                 num_items: Union[int, str] = 'infer'):
        if mat is None:
            assert users is not None and items is not None, (
                'Either 1) ``mat`` or 2) both ``users`` and ``items`` must be non-null!'
            )
            users = np.asarray(users)
            items = np.asarray(items)
            if len(users) != len(items):
                raise ValueError('Lengths of ``users`` and ``items`` must be equal.')

            num_users = _infer_num_if_needed(num_users, users)
            num_items = _infer_num_if_needed(num_items, items)

            if allow_missing_ids is False:
                _check_array_contains_all_integers(users, num_users, 'users')
                _check_array_contains_all_integers(items, num_items, 'items')

            if ratings is not None and len(users) != len(np.asarray(ratings)):
                raise ValueError(
                    'Length of ``ratings`` must be equal to lengths of ``users``, ``items``.'
                )

            mat = _create_sparse_ratings_matrix_helper(users=users,
                                                       items=items,
                                                       ratings=ratings,
                                                       num_users=num_users,
                                                       num_items=num_items)
        else:
            mat = coo_matrix(mat)
            if num_users == 'infer':
                num_users = mat.shape[0]
            if num_items == 'infer':
                num_items = mat.shape[1]
            if allow_missing_ids is False:
                _check_array_contains_all_integers(mat.row, num_users, 'mat.shape[0]')
                _check_array_contains_all_integers(mat.col, num_items, 'mat.shape[1]')

        if remove_duplicate_user_item_pairs:
            mat = self._remove_duplicate_pairs(mat)

        # normalize to canonical, duplicate-free COO with int64 coordinates
        self.mat = mat
        self.mat.row = self.mat.row.astype(np.int64)
        self.mat.col = self.mat.col.astype(np.int64)
        self.allow_missing_ids = allow_missing_ids
        self.remove_duplicate_user_item_pairs = remove_duplicate_user_item_pairs
        self.num_users = int(num_users)
        self.num_items = int(num_items)
        self.num_interactions = int(self.mat.nnz)
        self.min_rating = self.mat.data.min() if self.mat.nnz else 0
        self.max_rating = self.mat.data.max() if self.mat.nnz else 0

    @staticmethod
    def _remove_duplicate_pairs(mat: coo_matrix) -> coo_matrix:
        """Keep the *last* value for each duplicated ``(user, item)`` pair,
        matching the reference's DOK-overwrite semantics (``datasets.py:136-145``)."""
        keys = mat.row.astype(np.int64) * mat.shape[1] + mat.col.astype(np.int64)
        # np.unique keeps the first occurrence; reverse so "first" == original last
        _, keep_rev = np.unique(keys[::-1], return_index=True)
        keep = len(keys) - 1 - keep_rev
        keep.sort()
        return coo_matrix((mat.data[keep], (mat.row[keep], mat.col[keep])), shape=mat.shape)

    def __len__(self) -> int:
        return self.num_interactions

    def todense(self) -> np.matrix:
        return self.mat.todense()

    def toarray(self) -> np.ndarray:
        return self.mat.toarray()

    def head(self, n: int = 5) -> np.ndarray:
        n = self._prep_head_tail_n(n)
        return self.mat.tocsr()[range(n), :].toarray()

    def tail(self, n: int = 5) -> np.ndarray:
        n = self._prep_head_tail_n(n)
        return self.mat.tocsr()[range(-n, 0), :].toarray()

    def _prep_head_tail_n(self, n: int) -> int:
        if n < 0:
            n = self.num_users + n
        if n > self.num_users:
            n = self.num_users
        return n


class Interactions(BaseInteractions):
    """Implicit user-item interactions dataset.

    Mirrors ``Interactions`` (reference ``datasets.py:196-445``): zero ratings
    are filtered with a warning, ``num_negative_samples`` is validated against
    the catalog size, and negative sampling supports an *exact* mode (sampled
    negatives are guaranteed not to collide with the user's positives, with a
    bounded resample budget) and an *approximate* mode
    (``max_number_of_samples_to_consider=0``; plain uniform draws).

    The exact mode replaces the reference's per-sample Python rejection loop
    (``datasets.py:404-424``) with bounded vectorized re-draw rounds against a
    sorted key array — see ``collie_tpu_torch.data.sampling.NegativeSampler``.
    """

    def __init__(self,
                 mat: Optional[Union[coo_matrix, np.ndarray]] = None,
                 users: Optional[Iterable[int]] = None,
                 items: Optional[Iterable[int]] = None,
                 ratings: Optional[Iterable[float]] = None,
                 num_negative_samples: int = 10,
                 allow_missing_ids: bool = False,
                 remove_duplicate_user_item_pairs: bool = True,
                 num_users: Union[int, str] = 'infer',
                 num_items: Union[int, str] = 'infer',
                 check_num_negative_samples_is_valid: bool = True,
                 max_number_of_samples_to_consider: int = 200,
                 seed: Optional[int] = None):
        if mat is None and ratings is not None:
            ratings = np.asarray(ratings)
            if (ratings == 0).any():
                warnings.warn(
                    '``ratings`` contain ``0``s, which are ignored for implicit data. '
                    'Filtering these rows out.'
                )
                keep = ratings != 0
                users = np.asarray(users)[keep]
                items = np.asarray(items)[keep]
                ratings = ratings[keep]

        super().__init__(mat=mat,
                         users=users,
                         items=items,
                         ratings=ratings,
                         allow_missing_ids=allow_missing_ids,
                         remove_duplicate_user_item_pairs=remove_duplicate_user_item_pairs,
                         num_users=num_users,
                         num_items=num_items)

        if seed is None:
            seed = get_random_seed()

        self.num_negative_samples = int(num_negative_samples)
        self.max_number_of_samples_to_consider = int(max_number_of_samples_to_consider)
        self.check_num_negative_samples_is_valid = check_num_negative_samples_is_valid
        self.seed = seed

        assert self.num_negative_samples >= 1

        if (self.num_negative_samples >= self.max_number_of_samples_to_consider
                and self.max_number_of_samples_to_consider > 0):
            warnings.warn(
                '``num_negative_samples > max_number_of_samples_to_consider``. '
                'Approximate negative sampling will be used.'
            )

        if self.check_num_negative_samples_is_valid:
            # validation mirrors reference ``datasets.py:341-357``
            counts = np.bincount(self.mat.row, minlength=self.num_users)
            max_interactions_per_user = int(counts.max()) if len(counts) else 0
            is_valid = self.num_negative_samples < (self.num_items - max_interactions_per_user)
            assert is_valid, '``num_negative_samples`` must be less than {}!'.format(
                self.num_items - max_interactions_per_user
            )

        # sorted flat-key array of positives for O(log n) vectorized membership
        # tests — the vectorized replacement for the reference's Python ``set``
        # of (row, col) tuples (``datasets.py:359-366``)
        self.positive_keys = np.sort(
            self.mat.row.astype(np.int64) * self.num_items + self.mat.col.astype(np.int64)
        )
        self._rng = np.random.default_rng(self.seed)

    @property
    def exact_negative_sampling(self) -> bool:
        return self.max_number_of_samples_to_consider > 0

    def contains_pairs(self, user_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """Vectorized membership test: is each ``(user, item)`` a known positive?"""
        keys = np.asarray(user_ids, dtype=np.int64) * self.num_items + \
            np.asarray(item_ids, dtype=np.int64)
        idx = np.searchsorted(self.positive_keys, keys)
        idx = np.minimum(idx, len(self.positive_keys) - 1)
        return self.positive_keys[idx] == keys

    def __repr__(self) -> str:
        return (
            f'Interactions object with {self.num_interactions} interactions between '
            f'{self.num_users} users and {self.num_items} items, returning '
            f'{self.num_negative_samples} negative samples per interaction.'
        )

    def __getitem__(self, index: Union[int, Iterable[int]]
                    ) -> Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray]:
        """Batch-shape-compatible access (reference ``datasets.py:378-388``):
        returns ``((user_ids, item_ids), negative_item_ids)``."""
        from collie_tpu_torch.data.sampling import NegativeSampler

        scalar = np.isscalar(index) or (isinstance(index, np.ndarray) and index.ndim == 0)
        idx = np.atleast_1d(np.asarray(index))
        user_ids = self.mat.row[idx]
        item_ids = self.mat.col[idx]
        sampler = NegativeSampler(self)
        negatives = sampler.sample(user_ids, rng=self._rng)
        if scalar:
            return (user_ids[0], item_ids[0]), negatives[0]
        return (user_ids, item_ids), negatives


class ExplicitInteractions(BaseInteractions):
    """Explicit-feedback dataset: keeps real-valued ratings and yields flat
    ``(user, item, rating)`` triples (reference ``datasets.py:448-562``).

    The flat-vs-nested batch shape is the implicit/explicit protocol
    discriminator the training step dispatches on (reference
    ``base_pipeline.py:603-652``).
    """

    def __init__(self,
                 mat: Optional[Union[coo_matrix, np.ndarray]] = None,
                 users: Optional[Iterable[int]] = None,
                 items: Optional[Iterable[int]] = None,
                 ratings: Optional[Iterable[float]] = None,
                 allow_missing_ids: bool = False,
                 remove_duplicate_user_item_pairs: bool = True,
                 num_users: Union[int, str] = 'infer',
                 num_items: Union[int, str] = 'infer'):
        if mat is None and ratings is None:
            raise ValueError('``ratings`` must be provided for ``ExplicitInteractions``.')
        super().__init__(mat=mat,
                         users=users,
                         items=items,
                         ratings=ratings,
                         allow_missing_ids=allow_missing_ids,
                         remove_duplicate_user_item_pairs=remove_duplicate_user_item_pairs,
                         num_users=num_users,
                         num_items=num_items)

    @property
    def num_negative_samples(self) -> int:
        """Does not exist for explicit data (reference ``datasets.py:539-542``)."""
        raise AttributeError(
            '``num_negative_samples`` does not exist for explicit datasets.')

    def __repr__(self) -> str:
        return (
            f'ExplicitInteractions object with {self.num_interactions} interactions between '
            f'{self.num_users} users and {self.num_items} items.'
        )

    def __getitem__(self, index: Union[int, Iterable[int]]
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        idx = np.asarray(index)
        return self.mat.row[idx], self.mat.col[idx], self.mat.data[idx]


class HDF5Interactions:
    """Out-of-core interactions over an HDF5 store
    (``collie_tpu/data/interactions.py:310``), not ported: it needs
    ``h5py``, which the card's machine lacks (ROADMAP Queue 1, the
    out-of-core tier)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            'the out-of-core HDF5 tier is not ported yet (ROADMAP Queue 1)')
