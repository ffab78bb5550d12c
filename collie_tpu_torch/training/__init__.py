"""Training: optimizers written out by hand (and custom optimizer
factories), host lr schedulers, the whole-epoch engine and the trainer with
its per-step path and checkpoints."""
from collie_tpu_torch.training.optimizers import (OptimizerSpec, OptState, build_transform,
                                                  get_lr, set_lr, split_bias_keys)
from collie_tpu_torch.training.schedulers import ReduceLROnPlateau, StepLR, resolve_scheduler
from collie_tpu_torch.training.trainer import CollieMinimalTrainer, CollieTrainer

__all__ = ['CollieMinimalTrainer', 'CollieTrainer', 'OptState', 'OptimizerSpec',
           'ReduceLROnPlateau', 'StepLR', 'build_transform', 'get_lr', 'resolve_scheduler',
           'set_lr', 'split_bias_keys']
