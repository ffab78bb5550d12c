"""Host-side learning-rate schedulers.

The reference wires ``torch.optim.lr_scheduler`` objects (default
``ReduceLROnPlateau(patience=1)`` on the MF model,
the reference's ``collie/model/matrix_factorization.py:81-85``) monitoring
``val_loss_epoch`` / ``train_loss_epoch``
(``base_pipeline.py:375-399``).  Here schedulers are plain host objects that
decide a scale factor from the monitored epoch loss; the trainer applies it to
the learning rate inside the optimizer state.  The on-device scheduler state
of the JAX scan engine comes with the training slice.
"""
from typing import Optional


class ReduceLROnPlateau:
    """torch-compatible plateau scheduler (factor/patience/threshold semantics
    of ``torch.optim.lr_scheduler.ReduceLROnPlateau``)."""

    def __init__(self,
                 factor: float = 0.1,
                 patience: int = 10,
                 threshold: float = 1e-4,
                 min_lr: float = 0.0,
                 verbose: bool = False):
        assert 0.0 < factor < 1.0
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.verbose = verbose
        self.best: Optional[float] = None
        self.num_bad_epochs = 0

    def step(self, metric: float) -> Optional[float]:
        """Record this epoch's monitored loss; return an lr scale factor to
        apply (or ``None`` to leave the lr unchanged)."""
        if self.best is None or metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
            return None
        self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.num_bad_epochs = 0
            if self.verbose:
                print(f'ReduceLROnPlateau: reducing learning rate by {self.factor}x')
            return self.factor
        return None


class StepLR:
    """Decay the lr by ``gamma`` every ``step_size`` epochs
    (torch ``StepLR`` equivalent)."""

    def __init__(self, step_size: int, gamma: float = 0.1):
        self.step_size = step_size
        self.gamma = gamma
        self._epoch = 0

    def step(self, metric: float = None) -> Optional[float]:
        self._epoch += 1
        if self._epoch % self.step_size == 0:
            return self.gamma
        return None


def resolve_scheduler(lr_scheduler_func):
    """Normalize the model's ``lr_scheduler_func`` hparam into a fresh
    scheduler instance (or None).

    Accepts: ``None``; a scheduler instance (used as a template — a fresh copy
    is created per optimizer); or a zero-arg factory callable returning a
    scheduler (the functional analog of the reference's
    ``partial(ReduceLROnPlateau, patience=1)`` constructor pattern).
    """
    if lr_scheduler_func is None:
        return None
    if isinstance(lr_scheduler_func, (ReduceLROnPlateau, StepLR)):
        import copy
        return copy.deepcopy(lr_scheduler_func)
    if callable(lr_scheduler_func):
        return lr_scheduler_func()
    raise ValueError(f'Unrecognized lr scheduler: {lr_scheduler_func!r}')
