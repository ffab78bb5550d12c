"""Profiling and tracing utilities.

Port of ``collie_tpu/training/profiler.py``.  The reference's observability
is tqdm progress bars plus a wall-clock section timer
(``collie/model/base/trainer.py:339-344``, ``utils.py:411-431``); on top of
it:

* ``trace(logdir)``: context manager around ``torch.profiler.profile``
  (CPU activities, and CUDA ones when a CUDA device is present) that writes
  a Chrome trace (``chrome://tracing``, Perfetto) of the region into
  ``logdir``;
* ``annotate(name)``: names a host region so it shows up in the trace
  (``torch.profiler.record_function``); outside a trace it returns a
  shared ``nullcontext`` and costs one check.  The port names its own
  stages with it: ``collie.fit`` and, inside it, ``collie.fit.setup``
  (``collie.fit.epoch_tables`` > ``collie.fit.sampler_tables``,
  ``collie.fit.opt_states``), ``collie.fit.epochs`` (in the generic epoch
  ``collie.fit.step`` a step, holding ``collie.loss.select``, the sparse
  loss's selection pass) and ``collie.fit.finish``; ``collie.fit.stage``
  around a multi-stage model's ``set_stage``; ``collie.hybrid.metadata``
  around each metadata gather, tower and concatenation of the hybrid
  models' scores; ``collie.recommend`` > ``collie.recommend.prepare`` (>
  ``collie.recommend.seen``); and ``collie.sync`` around each deliberate
  host wait on the card (a flight's transfer, a CUDA-event read, a loss
  read back, a recommendation's copy to the host);
* ``count(name, n)``: a program counter.  Inside an active trace it adds
  ``n`` to ``name`` in every open ``counting()`` region; outside a trace it
  costs one check, as ``annotate`` does.  The port counts
  ``collie.hybrid.metadata_rows``, the metadata rows the hybrid models
  gather (every row of each gather, pad rows of a batch included);
* ``device_memory_stats()``: the CUDA caching allocator's statistics;
* ``EpochTimer``: per-epoch wall-clock and loss collector usable as a
  trainer logger.

A submodule only, as in ``collie_tpu``: ``training/__init__.py`` does not
export it.
"""
import collections
import contextlib
import os
import time
from typing import Dict, List, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Capture a trace of the region into ``logdir``
    (``trace_<pid>_<ns>.json``, Chrome trace format).  ``create_perfetto_link``
    is accepted for API parity: open the file in https://ui.perfetto.dev."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


#: the context ``annotate`` returns while no profiler runs
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """Name a host region inside an active trace; while no profiler runs,
    a shared no-op context that never enters the dispatcher."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return record_function(name)


#: the ``counting()`` regions open now, innermost last
_COUNTING: List[collections.Counter] = []


@contextlib.contextmanager
def counting():
    """A region that collects the program's counters (``count``) while a
    trace runs inside it; yields the ``collections.Counter`` they add to."""
    counts = collections.Counter()
    _COUNTING.append(counts)
    try:
        yield counts
    finally:
        _COUNTING.remove(counts)


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` of each open ``counting()`` region
    inside an active trace; outside a trace, one check and nothing else."""
    if not torch._C._autograd._profiler_enabled():
        return
    for counts in _COUNTING:
        counts[name] += n


def device_memory_stats() -> Optional[Dict[str, int]]:
    """The current CUDA device's memory statistics
    (``torch.cuda.memory_stats()``: allocated, reserved, peak, ... bytes),
    or None where no CUDA device is present."""
    if not torch.cuda.is_available():
        return None
    return dict(torch.cuda.memory_stats())


class EpochTimer:
    """Trainer-compatible logger collecting per-epoch losses and timings.

    Usage::

        timer = EpochTimer()
        trainer = CollieTrainer(model, logger=timer, ...)
        trainer.fit(model)
        print(timer.summary())
    """

    def __init__(self):
        self.epoch_losses: List[float] = []
        self.val_losses: List[float] = []
        self._epoch_times: List[float] = []
        self._last = time.perf_counter()

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        now = time.perf_counter()
        if 'train_loss_epoch' in metrics:
            self.epoch_losses.append(metrics['train_loss_epoch'])
            self._epoch_times.append(now - self._last)
            self._last = now
        if 'val_loss_epoch' in metrics:
            self.val_losses.append(metrics['val_loss_epoch'])

    def summary(self) -> Dict[str, float]:
        if not self._epoch_times:
            return {}
        return {
            'epochs': len(self.epoch_losses),
            'mean_epoch_seconds': sum(self._epoch_times) / len(self._epoch_times),
            'final_train_loss': self.epoch_losses[-1],
            'final_val_loss': self.val_losses[-1] if self.val_losses else None,
        }
