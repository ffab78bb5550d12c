"""Batch loaders producing fixed-shape numpy batches.

Numpy copy of ``collie_tpu.data.loaders`` (``InteractionsDataLoader`` only;
the approximate and HDF5 loaders come with training).

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
    Interactions
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
