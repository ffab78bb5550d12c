"""Data layer: interaction datasets, vectorized samplers, loaders, splits."""
from collie_tpu_torch.data.cross_validation import random_split, stratified_split
from collie_tpu_torch.data.interactions import (BaseInteractions,
                                                ExplicitInteractions,
                                                Interactions)
from collie_tpu_torch.data.loaders import (BaseInteractionsDataLoader,
                                           InteractionsDataLoader)
from collie_tpu_torch.data.sampling import NegativeSampler
from collie_tpu_torch.data import synthetic

__all__ = [
    'BaseInteractions',
    'BaseInteractionsDataLoader',
    'ExplicitInteractions',
    'Interactions',
    'InteractionsDataLoader',
    'NegativeSampler',
    'random_split',
    'stratified_split',
    'synthetic',
]
