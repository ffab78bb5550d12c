"""The benchmark's reader of the bucketed sampler kernel's time,
``sampler_kernel_ms.train``: a known value from a hand-built trace whose
kernel name is the one the profiler gives the kernel on the card, None
where the program launches no such kernel (as a program whose sampler is
torch operations) or the run has no trace, and ``BENCHMARK.json`` checked
by ``portbench.spec.validate`` with the metric on the two implicit cells."""
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness, spec  # noqa: E402
from portbench.tracing import TraceSummary  # noqa: E402

METRIC = 'sampler_kernel_ms.train'
KERNEL = ('void (anonymous namespace)::bucketed_sample_kernel<16>((anonymous namespace)::'
          'Buckets, float const*, int const*, int const*, int, int, int, int*)')
SCAN = ('void at::native::tensor_kernel_scan_innermost_dim<long, std::plus<long> >(long*, '
        'long const*, unsigned int, unsigned int, unsigned int, long, std::plus<long>)')
EPOCH = 'void (anonymous namespace)::mf_epoch_kernel<32, 10>(...)'
WINDOW = [('portbench.window', 0, 10 ** 9)]


def _read(device_ops, host=WINDOW):
    trace = TraceSummary(device_ops, host)
    return spec.metric_module(METRIC).read(harness.Run({}, trace))


def test_reads_the_kernels_time_a_launch():
    ops = [(KERNEL, 100_000, 1_300_000), (EPOCH, 1_400_000, 16_000_000),
           (KERNEL, 20_000_000, 21_100_000), (EPOCH, 21_200_000, 36_000_000),
           (KERNEL, 40_000_000, 41_250_000)]
    assert _read(ops) == pytest.approx((1.2 + 1.1 + 1.25) / 3)


def test_silent_without_the_kernel_or_a_trace():
    assert _read([(SCAN, 100_000, 500_000), (EPOCH, 600_000, 16_000_000)]) is None
    assert _read([]) is None
    assert spec.metric_module(METRIC).read(harness.Run({}, None)) is None


def test_declared_on_the_implicit_cells():
    loaded = spec.load_spec()
    assert spec.validate(loaded) == []
    declared = {m['name']: m for m in loaded['per_layer']}[METRIC]
    assert declared['workloads'] == ['mf_ml10m.fit_implicit', 'neumf_ml20m.fit_implicit',
                                     'hybrid_ml20m.fit_staged']
    assert declared['moves'] == 'train_examples_per_s' and declared['layer'] == 'Epoch build'
    assert declared['source'] == 'device_trace' and declared['unit'] == 'ms'
    assert [m['name'] for m in loaded['per_layer']].count(METRIC) == 1
