"""Import-path parity module: ``collie_tpu_torch.loss`` mirrors ``collie.loss``
(reference ``collie/loss/__init__.py``)."""
from collie_tpu_torch.ops.losses import (adaptive_bpr_loss,
                                         adaptive_hinge_loss,
                                         bpr_loss,
                                         hinge_loss,
                                         ideal_difference_from_metadata,
                                         mae_loss,
                                         mse_loss,
                                         warp_loss)

__all__ = [
    'adaptive_bpr_loss', 'adaptive_hinge_loss', 'bpr_loss', 'hinge_loss',
    'ideal_difference_from_metadata', 'mae_loss', 'mse_loss', 'warp_loss',
]
