"""The program's own spans in a traced window: ``collie.*`` host spans,
which ``collie_tpu_torch.training.profiler.annotate`` opens inside
``CollieTrainer.fit`` and ``retrieval.recommend``, found in
``run.trace.host_ops`` and counted per span the benchmark opens around each
call (``portbench.fit``, ``portbench.request``).  Where the program opens
no such span, as a version without them, each reading is None."""
from typing import Optional

import numpy as np


def named(trace, name: str) -> np.ndarray:
    """``[n, 2]`` start and end ns of every host span called ``name``."""
    ops = [(start, end) for n, start, end in trace.host_ops if n == name]
    return np.asarray(ops, dtype=np.int64).reshape(-1, 2)


def inside(spans: np.ndarray, outer: np.ndarray) -> np.ndarray:
    """The rows of ``spans`` that lie within one of the disjoint spans
    ``outer``."""
    if len(spans) == 0 or len(outer) == 0:
        return spans[:0]
    outer = outer[np.argsort(outer[:, 0], kind='stable')]
    i = np.searchsorted(outer[:, 0], spans[:, 0], side='right') - 1
    held = (i >= 0) & (spans[:, 1] <= outer[np.maximum(i, 0), 1])
    return spans[held]


def calls(run, outer: str) -> Optional[np.ndarray]:
    trace = run.trace
    if trace is None:
        return None
    spans = trace.spans.get(outer)
    return spans if spans is not None and len(spans) else None


def ms_per_call(run, name: str, outer: str) -> Optional[float]:
    """Milliseconds of the ``name`` spans inside the benchmark's ``outer``
    spans, summed, over the count of ``outer`` spans."""
    outer_spans = calls(run, outer)
    if outer_spans is None:
        return None
    spans = inside(named(run.trace, name), outer_spans)
    if len(spans) == 0:
        return None
    return float((spans[:, 1] - spans[:, 0]).sum()) / len(outer_spans) / 1e6


def count_per_call(run, name: str, within: str, outer: str) -> Optional[float]:
    """The ``name`` spans inside the program's ``within`` spans (those inside
    the benchmark's ``outer`` spans), over the count of ``outer`` spans."""
    outer_spans = calls(run, outer)
    if outer_spans is None:
        return None
    holders = inside(named(run.trace, within), outer_spans)
    if len(holders) == 0:
        return None
    return len(inside(named(run.trace, name), holders)) / len(outer_spans)
