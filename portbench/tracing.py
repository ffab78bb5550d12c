"""The traced run: ``torch.profiler`` over the measured window, reduced in
memory to what the per-layer metrics and the breakdown read.

Nothing is written to disk.  The window is the host span
``portbench.window``; the device's busy time is the union of the
intervals of every operation on the card (kernels, copies, sets) inside
it, so operations that overlap count once and idle time before the first
and after the last operation counts as idle.  Host annotations, which the
profiler mirrors on the card's timeline, are not device operations.  Host spans the harness opens
(``portbench.*``) are kept by name for the metrics that need them.
"""
import heapq
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

WINDOW = 'portbench.window'
SPAN_PREFIX = 'portbench.'


def _ns(event, what: str) -> int:
    fn = getattr(event, f'{what}_ns', None)
    if fn is not None:
        return int(fn())
    return int(getattr(event, f'{what}_us')() * 1000)


def _merge(starts: np.ndarray, ends: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint ``(starts, ends)``."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind='stable')
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.concatenate([first[1:] - 1, [len(s) - 1]])
    return s[first], reach[last]


class TraceSummary:
    """Device operations and host spans of one traced window (times in ns)."""

    def __init__(self, device_ops: List[Tuple[str, int, int]],
                 host_ops: List[Tuple[str, int, int]]):
        spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        for name, start, end in host_ops:
            if name.startswith(SPAN_PREFIX):
                spans[name].append((start, end))
        if not spans.get(WINDOW):
            raise RuntimeError(f'the trace holds no {WINDOW} span')
        self.t0, self.t1 = spans[WINDOW][0]
        self.spans = {k: np.asarray(sorted(v), dtype=np.int64).reshape(-1, 2)
                      for k, v in spans.items()}
        # a host annotation (``record_function``) is mirrored on the card's
        # timeline under its own name: that is no device operation
        host_names = {name for name, _, _ in host_ops}
        inside = [(n, max(s, self.t0), min(e, self.t1)) for n, s, e in device_ops
                  if e > self.t0 and s < self.t1 and n not in host_names]
        self.op_names = [n for n, _, _ in inside]
        self.op_start = np.asarray([s for _, s, _ in inside], dtype=np.int64)
        self.op_end = np.asarray([e for _, _, e in inside], dtype=np.int64)
        self.busy_start, self.busy_end = _merge(self.op_start, self.op_end)
        self._busy_cum = np.concatenate([[0], np.cumsum(self.busy_end - self.busy_start)])
        self.host_ops = [op for op in host_ops if op[2] > self.t0 and op[1] < self.t1]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return float(self._busy_cum[-1]) / 1e9

    def busy_between(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Device-busy ns inside each host interval ``[a_i, b_i]``."""
        if len(self.busy_start) == 0:
            return np.zeros(np.shape(a), dtype=np.int64)

        def cum(t):
            i = np.searchsorted(self.busy_start, t, side='right')     # intervals started
            full = self._busy_cum[np.maximum(i - 1, 0)]
            part = np.where(i > 0, np.minimum(t, self.busy_end[np.maximum(i - 1, 0)])
                            - self.busy_start[np.maximum(i - 1, 0)], 0)
            return np.where(i > 0, full + part, 0)
        return cum(np.asarray(b)) - cum(np.asarray(a))

    def op_seconds(self, contains: str) -> Tuple[float, int]:
        """Device seconds and count of the operations whose name holds
        ``contains``."""
        pick = np.asarray([contains in n for n in self.op_names], dtype=bool)
        if not pick.any():
            return 0.0, 0
        return float((self.op_end[pick] - self.op_start[pick]).sum()) / 1e9, int(pick.sum())

    def top_ops(self, n: int = 10) -> List[List]:
        total: Dict[str, int] = defaultdict(int)
        for name, s, e in zip(self.op_names, self.op_start, self.op_end):
            total[name[:120]] += int(e - s)
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_by_host(self, n: int = 10) -> List[List]:
        """Idle time of the card inside the window, summed by the innermost
        host operation running at each gap's midpoint."""
        edges_s = np.concatenate([[self.t0], self.busy_end])
        edges_e = np.concatenate([self.busy_start, [self.t1]])
        keep = edges_e > edges_s
        gap_s, gap_e = edges_s[keep], edges_e[keep]
        mids = (gap_s + gap_e) // 2
        order = np.argsort(mids)
        ops = sorted(self.host_ops, key=lambda op: op[1])
        heap: List[Tuple[int, int, str]] = []       # (-start, end, name)
        j = 0
        total: Dict[str, int] = defaultdict(int)
        for g in order:
            t = mids[g]
            while j < len(ops) and ops[j][1] <= t:
                heapq.heappush(heap, (-ops[j][1], ops[j][2], ops[j][0]))
                j += 1
            # t only grows, so an op that ended before it is done for good;
            # one buried under a later-starting op is dropped when it surfaces
            while heap and heap[0][1] < t:
                heapq.heappop(heap)
            label = heap[0][2] if heap else '(no host operation)'
            total[label[:120]] += int(gap_e[g] - gap_s[g])
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def breakdown(self) -> Dict[str, List[List]]:
        return {'device_ops': self.top_ops(), 'idle_gaps': self.idle_by_host()}


class Tracer:
    """Context manager: profile the card and the host, then reduce."""

    def __init__(self):
        self.summary: Optional[TraceSummary] = None
        self._prof = None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        device_ops, host_ops = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = _ns(e, 'start')
            item = (e.name(), start, start + _ns(e, 'duration'))
            (device_ops if 'CUDA' in str(e.device_type()) else host_ops).append(item)
        self._prof = None
        self.summary = TraceSummary(device_ops, host_ops)
        return False
