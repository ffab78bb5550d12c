"""Import-path parity module: ``collie_tpu_torch.interactions`` mirrors
``collie.interactions`` (reference ``collie/interactions/__init__.py``)."""
from collie_tpu_torch.data.interactions import (BaseInteractions,
                                                ExplicitInteractions,
                                                HDF5Interactions,
                                                Interactions)
from collie_tpu_torch.data.loaders import (ApproximateNegativeSamplingInteractionsDataLoader,
                                           BaseInteractionsDataLoader,
                                           HDF5InteractionsDataLoader,
                                           InteractionsDataLoader)
from collie_tpu_torch.data.sampling import NegativeSampler

__all__ = [
    'ApproximateNegativeSamplingInteractionsDataLoader', 'BaseInteractions',
    'BaseInteractionsDataLoader', 'ExplicitInteractions', 'HDF5Interactions',
    'HDF5InteractionsDataLoader', 'Interactions', 'InteractionsDataLoader',
    'NegativeSampler',
]
