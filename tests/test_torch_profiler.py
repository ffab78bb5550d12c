"""The port's ``training/profiler.py`` against collie_tpu's.

``EpochTimer`` follows JAX's logic line for line: under one fake clock the
same ``log_metrics`` calls give the same ``summary()``.  ``trace`` writes a
Chrome trace naming an ``annotate``d region (on the CPU here; the card's
kernels in ``chip_smoke.py`` phase 12), and ``device_memory_stats`` is None
without a CUDA device, as JAX's is None where the backend exposes none.
"""
import itertools
import json
import time

import numpy as np
import pytest
import torch

from collie_tpu.training import profiler as jax_profiler
from collie_tpu_torch.training import profiler

CALLS = [({'train_loss_epoch': 0.9}, 0), ({'val_loss_epoch': 0.8}, 0),
         ({'train_loss_epoch': 0.7, 'val_loss_epoch': 0.6}, 1), ({'lr': 0.1}, 1),
         ({'train_loss_epoch': 0.5}, 2)]


def _fake_clock(monkeypatch):
    ticks = itertools.count(start=10.0, step=1.25)
    monkeypatch.setattr(time, 'perf_counter', lambda: next(ticks))


@pytest.mark.parametrize('n_calls', [0, 1, 2, len(CALLS)])
def test_epoch_timer_summary_equals_jax(n_calls, monkeypatch):
    summaries = []
    for module in (profiler, jax_profiler):
        _fake_clock(monkeypatch)
        timer = module.EpochTimer()
        for metrics, step in CALLS[:n_calls]:
            timer.log_metrics(metrics, step)
        summaries.append((timer.summary(), timer.epoch_losses, timer.val_losses))
    assert summaries[0] == summaries[1]


def test_epoch_timer_logs_a_port_fit():
    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel
    from collie_tpu_torch.data import Interactions

    rng = np.random.default_rng(0)
    train = Interactions(users=rng.integers(0, 30, 400), items=rng.integers(0, 50, 400),
                         num_users=30, num_items=50, allow_missing_ids=True,
                         check_num_negative_samples_is_valid=False, seed=0)
    model = MatrixFactorizationModel(train=train, embedding_dim=4, seed=0, map_location='cpu')
    timer = profiler.EpochTimer()
    CollieTrainer(model, max_epochs=2, logger=timer, verbosity=0).fit(model)
    summary = timer.summary()
    assert summary['epochs'] == 2 and summary['mean_epoch_seconds'] > 0
    assert summary['final_train_loss'] == timer.epoch_losses[-1]
    assert summary['final_val_loss'] is None


def test_trace_writes_the_annotated_region(tmp_path):
    with profiler.trace(str(tmp_path)):
        with profiler.annotate('collie_region'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(tmp_path.glob('trace_*.json'))
    assert len(files) == 1
    events = json.loads(files[0].read_text())['traceEvents']
    assert any(e.get('name') == 'collie_region' for e in events)
    assert any('mm' in str(e.get('name')) for e in events)


def test_device_memory_stats_is_none_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert profiler.device_memory_stats() is None


def test_profiler_is_a_submodule_only():
    import collie_tpu.training as jax_training
    import collie_tpu_torch.training as training

    for name in ('trace', 'annotate', 'device_memory_stats', 'EpochTimer'):
        assert hasattr(profiler, name) and hasattr(jax_profiler, name)
        assert hasattr(training, name) == hasattr(jax_training, name)
