"""Training: host-side lr schedulers (the engine comes with the training slice)."""
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau, StepLR, resolve_scheduler

__all__ = ['ReduceLROnPlateau', 'StepLR', 'resolve_scheduler']
