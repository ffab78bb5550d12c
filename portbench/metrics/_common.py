"""Arithmetic shared by the per-layer metric readers.

Each reader is ``read(run) -> float or None``: ``run.inputs`` is what its
driver recorded in the window (``fits`` or ``requests``, the shapes), and
``run.trace`` the reduced trace.  A reader that finds nothing to read
returns None, and the metric is left out of the line."""
from typing import Optional

import numpy as np

from portbench.metrics import _counts


def idle_share(run) -> Optional[float]:
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def request_host_ms(run) -> Optional[float]:
    """Mean over requests of the request's wall time minus the time the
    card was busy inside it."""
    trace = run.trace
    if trace is None:
        return None
    spans = trace.spans.get('portbench.request')
    if spans is None or len(spans) == 0:
        return None
    wall = spans[:, 1] - spans[:, 0]
    busy = trace.busy_between(spans[:, 0], spans[:, 1])
    return float(np.mean(wall - busy)) / 1e6


def serve_mfu(run) -> Optional[float]:
    requests = run.inputs.get('requests')
    if not requests:
        return None
    shape = run.inputs['shape']
    flops = sum(_counts.topk_request(r['users'], shape['num_items'], shape['dim'],
                                     shape['k'])[0] for r in requests)
    return 100.0 * flops / run.inputs['window_s'] / _counts.PEAK_FP32_FLOPS


def epoch_counts(run):
    shape = run.inputs['shape']
    if shape['feedback'] == 'implicit':
        return _counts.implicit_epoch(shape['num_users'], shape['num_items'], shape['dim'],
                                      shape['steps'], shape['batch'], shape['negatives'])
    return _counts.explicit_epoch(shape['num_users'], shape['num_items'], shape['dim'],
                                  shape['steps'], shape['batch'])


def epoch_split_ms(run, key: str) -> Optional[float]:
    """An ``epoch_log`` split summed over the window's epochs, over the
    epochs."""
    values = [entry[key] for fit in run.inputs.get('fits', []) for entry in fit['log']
              if key in entry]
    if not values:
        return None
    return float(np.sum(values)) / len(values)
