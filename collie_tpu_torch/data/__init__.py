"""Data layer: interaction datasets, vectorized samplers, loaders, splits."""
from collie_tpu_torch.data.cross_validation import random_split, stratified_split
from collie_tpu_torch.data.interactions import (BaseInteractions,
                                                ExplicitInteractions,
                                                HDF5Interactions,
                                                Interactions,
                                                write_hdf5_meta)
from collie_tpu_torch.data.loaders import (ApproximateNegativeSamplingInteractionsDataLoader,
                                           BaseInteractionsDataLoader,
                                           HDF5InteractionsDataLoader,
                                           InteractionsDataLoader)
from collie_tpu_torch.data.prefetch import PrefetchLoader
from collie_tpu_torch.data.sampling import NegativeSampler
from collie_tpu_torch.data import synthetic

__all__ = [
    'ApproximateNegativeSamplingInteractionsDataLoader',
    'BaseInteractions',
    'BaseInteractionsDataLoader',
    'ExplicitInteractions',
    'HDF5Interactions',
    'HDF5InteractionsDataLoader',
    'Interactions',
    'InteractionsDataLoader',
    'NegativeSampler',
    'PrefetchLoader',
    'random_split',
    'stratified_split',
    'synthetic',
    'write_hdf5_meta',
]
