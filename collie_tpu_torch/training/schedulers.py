"""Learning-rate schedulers, on the host and on the device.

The reference wires ``torch.optim.lr_scheduler`` objects (default
``ReduceLROnPlateau(patience=1)`` on the MF model,
the reference's ``collie/model/matrix_factorization.py:81-85``) monitoring
``val_loss_epoch`` / ``train_loss_epoch``
(``base_pipeline.py:375-399``).  Here schedulers are plain host objects that
decide a scale factor from the monitored epoch loss; the per-epoch loop
applies it to the learning rate inside the optimizer state.

The whole fit (``scan_engine.build_scan_fit_fn``) steps them on the device
instead, as the JAX package does (``collie_tpu/training/schedulers.py:66-99``,
``scan_engine.py:848-863``): ``scheduler_device_config`` expresses a
scheduler as ``(kind, statics, state)`` with 0-d device tensors,
``scheduler_device_step`` is one step in float32 tensor arithmetic, and
``scheduler_absorb_device_state`` writes the final state back into the host
object.  The host ``ReduceLROnPlateau`` compares in float32 too, and the
per-epoch loop scales the learning rate in float32 (``scaled_lr``), so both
loops take the same decisions and reach the same learning rates, those of
JAX's default whole fit.
"""
from typing import Optional, Tuple

import numpy as np
import torch


def scaled_lr(lr: float, factor: float, min_lr: float = 0.0) -> float:
    """``max(lr * factor, min_lr)`` in float32, as the device step computes
    it: each operand rounded to float32, then one float32 product."""
    return float(max(np.float32(lr) * np.float32(factor), np.float32(min_lr)))


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
        if self.best is None or (np.float32(metric)
                                 < np.float32(self.best) * np.float32(1 - self.threshold)):
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


def scheduler_device_config(scheduler, device) -> Optional[Tuple[str, tuple, tuple]]:
    """``scheduler`` as ``(kind, statics, state)`` for the device step:
    ``('plateau', (factor, patience, threshold, min_lr), (best, num_bad))``,
    ``('steplr', (step_size, gamma), (epoch,))`` or ``('none', (), ())``,
    the state as 0-d float32 / int32 tensors on ``device``; None for a
    scheduler with no device form (the fit then takes the per-epoch loop)."""
    if scheduler is None:
        return ('none', (), ())
    if isinstance(scheduler, ReduceLROnPlateau):
        best = np.inf if scheduler.best is None else float(scheduler.best)
        return ('plateau',
                (scheduler.factor, scheduler.patience, scheduler.threshold, scheduler.min_lr),
                (torch.full((), best, dtype=torch.float32, device=device),
                 torch.full((), scheduler.num_bad_epochs, dtype=torch.int32, device=device)))
    if isinstance(scheduler, StepLR):
        return ('steplr', (scheduler.step_size, scheduler.gamma),
                (torch.full((), scheduler._epoch, dtype=torch.int32, device=device),))
    return None


def scheduler_device_step(kind: str, statics: tuple, state: tuple, lr: torch.Tensor,
                          monitored: torch.Tensor) -> Tuple[tuple, torch.Tensor]:
    """One epoch's step of a device scheduler on 0-d tensors: ``(state,
    lr)`` after the epoch whose monitored loss is ``monitored``, in the JAX
    whole fit's float32 arithmetic (``scan_engine.py:848-863``)."""
    if kind == 'plateau':
        factor, patience, threshold, min_lr = statics
        best, num_bad = state
        improved = monitored < best * (1.0 - threshold)
        best = torch.where(improved, monitored, best)
        num_bad = torch.where(improved, 0, num_bad + 1)
        reduce = num_bad > patience
        num_bad = torch.where(reduce, 0, num_bad)
        return (best, num_bad), torch.where(reduce, torch.clamp_min(lr * factor, min_lr), lr)
    step_size, gamma = statics                                  # 'steplr'
    (epoch,) = state
    epoch = epoch + 1
    return (epoch,), torch.where(epoch % step_size == 0, lr * gamma, lr)


def scheduler_absorb_device_state(scheduler, state) -> None:
    """Write a device scheduler's final state (tensors or host numbers)
    back into the host object, so a later fit or checkpoint continues it."""
    if isinstance(scheduler, ReduceLROnPlateau):
        best, num_bad = float(state[0]), int(state[1])
        scheduler.best = best if np.isfinite(best) else None
        scheduler.num_bad_epochs = num_bad
    elif isinstance(scheduler, StepLR):
        scheduler._epoch = int(state[0])


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
