"""Interaction datasets over sparse user x item matrices.

Numpy copy of ``collie_tpu.data.interactions`` (reference
``collie/interactions/datasets.py``: ``BaseInteractions`` at ``:17``,
``Interactions`` at ``:196``, ``ExplicitInteractions`` at ``:448``) and of
its out-of-core ``HDF5Interactions`` / ``write_hdf5_meta`` (``:310-470``),
which import ``h5py`` where they read or write a store, so the package
imports without it.

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
    """Out-of-core interactions over an HDF5 store, read in contiguous chunks
    (``collie_tpu/data/interactions.py:310``; reference
    ``datasets.py:565-733``).

    The store layout is the one ``collie_tpu_torch.utils.pandas_df_to_hdf5``
    (and the JAX package's) writes: 1-d column datasets ``user_id`` /
    ``item_id`` (/ ``rating``) under a group, with an optional ``meta``
    group carrying ``num_users`` / ``num_items`` attributes
    (``write_hdf5_meta``).  Negative sampling for HDF5 data is always
    approximate, as in the reference (``datasets.py:664-694``); its draws
    are numpy's, so they equal the JAX package's for the same seed.
    """

    def __init__(self,
                 hdf5_path: str,
                 user_col: str = 'user_id',
                 item_col: str = 'item_id',
                 num_negative_samples: int = 10,
                 num_users: Union[int, str] = 'infer',
                 num_items: Union[int, str] = 'infer',
                 key: str = 'interactions',
                 shuffle: bool = False,
                 seed: Optional[int] = None):
        import h5py

        self.hdf5_path = str(hdf5_path)
        self.user_col = user_col
        self.item_col = item_col
        self.key = key
        self.num_negative_samples = int(num_negative_samples)
        self.shuffle = shuffle
        self.seed = seed if seed is not None else get_random_seed()
        self._rng = np.random.default_rng(self.seed)

        with h5py.File(self.hdf5_path, 'r') as f:
            grp = f[key]
            self.num_interactions = int(grp[user_col].shape[0])
            meta = f.get('meta')
            if meta is not None and 'num_users' in meta.attrs and num_users == 'infer':
                num_users = int(meta.attrs['num_users'])
            if meta is not None and 'num_items' in meta.attrs and num_items == 'infer':
                num_items = int(meta.attrs['num_items'])
            if num_users == 'infer' or num_items == 'infer':
                if self.num_interactions == 0:
                    raise ValueError(
                        f'Cannot infer ``num_users``/``num_items`` from an '
                        f'empty HDF5 store: {self.hdf5_path!r} key {key!r} '
                        f'has 0 interactions.')
                num_users, num_items = self._infer_sizes(grp, num_users, num_items)

        self.num_users = int(num_users)
        self.num_items = int(num_items)

    def _infer_sizes(self, grp, num_users, num_items) -> Tuple[int, int]:
        """A chunked max scan over the store (the reference's 100k-chunk
        pass, ``datasets.py:616-654``), which doubles as its zero-index
        check (``:632-650``): a 1-indexed store would shift every
        embedding row, so it fails loudly."""
        max_user = max_item = -1
        min_user = min_item = None
        chunk = 100_000
        for start in range(0, self.num_interactions, chunk):
            sl = slice(start, min(start + chunk, self.num_interactions))
            u, i = grp[self.user_col][sl], grp[self.item_col][sl]
            max_user = max(max_user, int(u.max()))
            max_item = max(max_item, int(i.max()))
            min_user = int(u.min()) if min_user is None else min(min_user, int(u.min()))
            min_item = int(i.min()) if min_item is None else min(min_item, int(i.min()))
        if min_user != 0 or min_item != 0:
            raise ValueError(
                f'Minimum values of {self.user_col} and {self.item_col} in HDF5 data '
                f'must both be 0, not {min_user} and {min_item}, respectively.'
            )
        return (max_user + 1 if num_users == 'infer' else num_users,
                max_item + 1 if num_items == 'infer' else num_items)

    def __len__(self) -> int:
        return self.num_interactions

    def head(self, n: int = 5) -> 'pd.DataFrame':
        """First ``n`` rows of the store as a DataFrame (reference
        ``datasets.py:716-719``); negative ``n`` counts from the end."""
        n = self._prep_head_tail_n(n)
        return self._read_df_chunk(0, n)

    def tail(self, n: int = 5) -> 'pd.DataFrame':
        """Last ``n`` rows of the store as a DataFrame (reference
        ``datasets.py:721-724``)."""
        n = self._prep_head_tail_n(n)
        return self._read_df_chunk(self.num_interactions - n, n)

    def _prep_head_tail_n(self, n: int) -> int:
        """Clamp ``n`` the way the reference does (``datasets.py:726-733``)."""
        if n < 0:
            n = self.num_interactions + n
        return min(max(n, 0), self.num_interactions)

    def _read_df_chunk(self, start: int, n: int) -> 'pd.DataFrame':
        """A DataFrame chunk in the store's column order (``column_order``
        first, then any dataset the attribute predates, name-sorted), with
        the rows' offsets as its index, as the reference's
        ``store.select`` gives it (``datasets.py:716-733``)."""
        import h5py
        import pandas as pd

        with h5py.File(self.hdf5_path, 'r') as f:
            grp = f[self.key]
            ordered = [c for c in grp.attrs.get('column_order', ()) if c in grp]
            cols = ordered + sorted(set(grp.keys()) - set(ordered))
            return pd.DataFrame(
                {col: np.asarray(grp[col][start:start + n]) for col in cols},
                columns=cols, index=range(start, start + n))

    def read_chunk(self, start: int, stop: int) -> Tuple[np.ndarray, np.ndarray]:
        """The raw contiguous ``[start, stop)`` user and item columns as
        int32: the chunk tier's read primitive (it shuffles and samples
        negatives on the device, ``training/scan_engine.build_hdf5_chunk_make``)."""
        import h5py

        with h5py.File(self.hdf5_path, 'r') as f:
            grp = f[self.key]
            return (np.asarray(grp[self.user_col][start:stop], dtype=np.int32),
                    np.asarray(grp[self.item_col][start:stop], dtype=np.int32))

    def __getitem__(self, index: Tuple[int, int]
                    ) -> Tuple[Tuple[np.ndarray, np.ndarray], np.ndarray]:
        """A contiguous ``(start_idx, batch_size)`` chunk (through
        ``read_chunk``, the one read of the store), shuffled inside when
        ``shuffle``, with approximate negatives ``[n, K]`` (reference
        ``datasets.py:664-694``).  Ids come back int64."""
        start_idx, batch_size = index
        stop = min(start_idx + batch_size, self.num_interactions)
        users, items = (ids.astype(np.int64) for ids in self.read_chunk(start_idx, stop))

        if self.shuffle:
            perm = self._rng.permutation(len(users))
            users, items = users[perm], items[perm]

        negatives = self._rng.integers(0, self.num_items,
                                       size=(len(users), self.num_negative_samples))
        return (users, items), negatives


def write_hdf5_meta(hdf5_path: str, num_users: int, num_items: int) -> None:
    """Write the ``meta`` group ``HDF5Interactions`` reads its sizes from."""
    import h5py

    with h5py.File(hdf5_path, 'a') as f:
        meta = f.require_group('meta')
        meta.attrs['num_users'] = num_users
        meta.attrs['num_items'] = num_items
