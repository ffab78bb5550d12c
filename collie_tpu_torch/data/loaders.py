"""Batch loaders producing fixed-shape numpy batches.

Numpy copy of ``collie_tpu.data.loaders``: ``InteractionsDataLoader``,
``ApproximateNegativeSamplingInteractionsDataLoader`` and the out-of-core
``HDF5InteractionsDataLoader``.

Rebuild of the reference's ``collie/interactions/dataloaders.py`` (loaders at
``:70``, ``:176``, ``:297``) without ``torch.utils.data``: each loader is a
plain re-iterable that yields dict batches

    implicit: ``{'users': [B], 'pos_items': [B], 'neg_items': [B, K], 'mask': [B]}``
    explicit: ``{'users': [B], 'items': [B], 'ratings': [B], 'mask': [B]}``

Every batch (including the last) has exactly ``batch_size`` rows — the
remainder is padded and masked out — so the train step sees one shape.
Negative sampling is vectorized per batch (``collie_tpu_torch.data.sampling``),
which subsumes the reference's ``ApproximateNegativeSampler`` /
``HDF5Sampler`` batch-index machinery
(``samplers.py:11-127``).
"""
from typing import Dict, Iterator, Optional

import numpy as np

from collie_tpu_torch.data.interactions import BaseInteractions, ExplicitInteractions, \
    HDF5Interactions, Interactions
from collie_tpu_torch.data.sampling import NegativeSampler

Batch = Dict[str, np.ndarray]


def _pad_to(arr: np.ndarray, size: int) -> np.ndarray:
    """Pad the leading axis to ``size`` by repeating the first row."""
    if arr.shape[0] == size:
        return arr
    pad = np.broadcast_to(arr[:1], (size - arr.shape[0],) + arr.shape[1:])
    return np.concatenate([arr, pad], axis=0)


class BaseInteractionsDataLoader:
    """Common proxying of dataset attributes (reference ``dataloaders.py:44-67``)."""

    interactions: BaseInteractions
    batch_size: int

    @property
    def num_users(self) -> int:
        return self.interactions.num_users

    @property
    def num_items(self) -> int:
        return self.interactions.num_items

    @property
    def num_negative_samples(self) -> int:
        return self.interactions.num_negative_samples

    @property
    def num_interactions(self) -> int:
        return self.interactions.num_interactions

    @property
    def mat(self):
        return self.interactions.mat

    def __len__(self) -> int:
        if getattr(self, 'drop_last', False):
            return self.num_interactions // self.batch_size
        return -(-self.num_interactions // self.batch_size)


class InteractionsDataLoader(BaseInteractionsDataLoader):
    """Default loader with exact negative sampling (reference ``dataloaders.py:70-173``).

    Accepts a ready ``Interactions``/``ExplicitInteractions`` or, like the
    reference's kwarg-splitting constructor (``dataloaders.py:127-151``),
    raw ``mat``/``users``/``items``/``ratings`` arrays from which it builds the
    ``Interactions`` itself.
    """

    _interactions_cls = Interactions

    def __init__(self,
                 interactions: Optional[BaseInteractions] = None,
                 batch_size: int = 1024,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 seed: Optional[int] = None,
                 **interactions_kwargs):
        if interactions is None:
            interactions = self._interactions_cls(**interactions_kwargs)
        self.interactions = interactions
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed if seed is not None else getattr(interactions, 'seed', 0)
        self._epoch = 0

        self.approximate_negative_sampling = (
            isinstance(interactions, Interactions) and not interactions.exact_negative_sampling
        )

    def _epoch_rng(self) -> np.random.Generator:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        return rng

    def __iter__(self) -> Iterator[Batch]:
        inter = self.interactions
        rng = self._epoch_rng()
        n = inter.num_interactions
        order = rng.permutation(n) if self.shuffle else np.arange(n)

        explicit = isinstance(inter, ExplicitInteractions)
        sampler = None if explicit else NegativeSampler(inter)
        B = self.batch_size

        row, col = inter.mat.row, inter.mat.col
        data = inter.mat.data

        stop = (n // B) * B if self.drop_last else n
        for start in range(0, stop, B):
            idx = order[start:start + B]
            actual = len(idx)
            mask = np.zeros(B, dtype=np.float32)
            mask[:actual] = 1.0
            users = _pad_to(row[idx], B)
            items = _pad_to(col[idx], B)
            if explicit:
                yield {
                    'users': users,
                    'items': items,
                    'ratings': _pad_to(data[idx].astype(np.float32), B),
                    'mask': mask,
                }
            else:
                negs = sampler.sample(users, rng=rng)
                yield {
                    'users': users,
                    'pos_items': items,
                    'neg_items': negs,
                    'mask': mask,
                }


class ApproximateNegativeSamplingInteractionsDataLoader(InteractionsDataLoader):
    """Loader with purely uniform ("approximate") negative sampling
    (reference ``dataloaders.py:176-294``).

    All loaders here are batch-vectorized, so this subclass only switches
    off the exact-collision redraw rounds.  Rejects explicit data as the
    reference does (``dataloaders.py:239-243``).  Like the reference, it
    sets ``max_number_of_samples_to_consider = 0`` on the ``Interactions``
    it is given, in place: every other loader over that object samples
    approximately from then on.
    """

    def __init__(self,
                 interactions: Optional[Interactions] = None,
                 batch_size: int = 1024,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 seed: Optional[int] = None,
                 **interactions_kwargs):
        if interactions is not None and isinstance(interactions, ExplicitInteractions):
            raise ValueError(
                '``ApproximateNegativeSamplingInteractionsDataLoader`` does not support '
                'explicit data — use ``InteractionsDataLoader`` instead.'
            )
        if interactions is None:
            interactions_kwargs['max_number_of_samples_to_consider'] = 0
            interactions = Interactions(**interactions_kwargs)
        elif interactions.exact_negative_sampling:
            # force approximate mode (reference ``dataloaders.py:256-265``)
            interactions.max_number_of_samples_to_consider = 0
        super().__init__(interactions=interactions,
                         batch_size=batch_size,
                         shuffle=shuffle,
                         drop_last=drop_last,
                         seed=seed)
        self.approximate_negative_sampling = True


class HDF5InteractionsDataLoader(BaseInteractionsDataLoader):
    """Chunked out-of-core loader (``collie_tpu/data/loaders.py:179``;
    reference ``dataloaders.py:297-397``).

    Shuffle permutes the order of the contiguous chunks (one
    ``default_rng((seed, epoch))`` permutation an epoch) and, inside
    ``HDF5Interactions``, the rows of each chunk; sampling is always
    approximate, as in the reference's ``HDF5Sampler``
    (``samplers.py:67-127``).  A loader built from ``hdf5_path`` hands its
    seed to the ``HDF5Interactions`` it builds.  The trainer trains such a
    loader through the chunk tier (``CollieTrainer``), which reads the
    store through ``read_chunk``; iterating it gives the per-step path's
    padded batches.
    """

    def __init__(self,
                 interactions: Optional[HDF5Interactions] = None,
                 hdf5_path: Optional[str] = None,
                 batch_size: int = 1024,
                 shuffle: bool = False,
                 drop_last: bool = False,
                 seed: Optional[int] = None,
                 **interactions_kwargs):
        if interactions is None:
            # without the loader's seed HDF5Interactions would take a
            # seconds-resolution time seed, and a seeded loader would still
            # sample irreproducible negatives
            interactions_kwargs.setdefault('seed', seed)
            interactions = HDF5Interactions(hdf5_path=hdf5_path, shuffle=shuffle,
                                            **interactions_kwargs)
        self.interactions = interactions
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed if seed is not None else interactions.seed
        self._epoch = 0
        self.approximate_negative_sampling = True

    @property
    def mat(self):
        raise AttributeError(
            'HDF5-backed data is out-of-core; the full interactions matrix is unavailable '
            '(reference ``dataloaders.py:381-385``).'
        )

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.default_rng((self.seed, self._epoch))
        self._epoch += 1
        n = self.interactions.num_interactions
        B = self.batch_size
        stop = (n // B) * B if self.drop_last else n
        starts = np.arange(0, stop, B)
        if self.shuffle:
            starts = rng.permutation(starts)
        for start in starts:
            (users, items), negs = self.interactions[(int(start), B)]
            mask = np.zeros(B, dtype=np.float32)
            mask[:len(users)] = 1.0
            yield {
                'users': _pad_to(users, B),
                'pos_items': _pad_to(items, B),
                'neg_items': _pad_to(negs, B),
                'mask': mask,
            }
