"""The benchmark's reader of the selection kernel's time,
``topk_select_ms.serve``: a known value from a hand-built trace whose kernel
names are those the profiler gives the two passes on the card, None where
the program launches no such kernel (as a program that still sorts) or the
trace holds no request, and ``BENCHMARK.json`` checked by
``portbench.spec.validate`` with the metric on the serving cell alone."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness, spec  # noqa: E402
from portbench.tracing import TraceSummary  # noqa: E402

METRIC = 'topk_select_ms.serve'
PASS_1 = ('void (anonymous namespace)::topk_select_segments_kernel<unsigned int, false, false>('
          'unsigned int const*, int, int, int, int, int, int, int, unsigned long long*, '
          'unsigned int*, long long*)')
PASS_2 = ('void (anonymous namespace)::topk_select_merge_kernel<unsigned int>(unsigned int '
          'const*, int, int, int, int, int, unsigned long long const*, unsigned int*, '
          'long long*)')
SORT = 'void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>'
GEMM = 'sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8_stage3_warpsize2x2x1'
#: two requests of the window; device times in ns
REQUESTS = [('portbench.window', 0, 10 ** 9), ('portbench.request', 0, 4_000_000),
            ('portbench.request', 5_000_000, 9_000_000)]


def _read(device_ops, host=REQUESTS):
    trace = TraceSummary(device_ops, host)
    return spec.metric_module(METRIC).read(harness.Run({}, trace))


def test_reads_both_passes_over_the_requests():
    ops = [(GEMM, 100_000, 200_000), (PASS_1, 300_000, 420_000), (PASS_2, 420_000, 426_000),
           (GEMM, 5_100_000, 5_200_000), (PASS_1, 5_300_000, 5_410_000)]
    assert _read(ops) == pytest.approx((0.120 + 0.006 + 0.110) / 2)


def test_silent_without_the_kernel_or_the_requests():
    assert _read([(GEMM, 100_000, 200_000), (SORT, 300_000, 5_000_000)]) is None
    assert _read([(PASS_1, 300_000, 420_000)], REQUESTS[:1]) is None
    assert spec.metric_module(METRIC).read(harness.Run({}, None)) is None


def test_declared_on_the_serving_cell_alone():
    loaded = spec.load_spec()
    assert spec.validate(loaded) == []
    declared = {m['name']: m for m in loaded['per_layer']}[METRIC]
    assert declared['workloads'] == ['mf_msd.recommend_batch']
    assert declared['moves'] == 'recommend_users_per_s' and declared['layer'] == 'Kernels'
    names = [m['name'] for m in loaded['per_layer']]
    assert names.index(METRIC) == names.index('step_host_ms.neumf') + 1
