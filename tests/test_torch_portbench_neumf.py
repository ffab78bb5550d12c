"""The benchmark's NeuMF cell on the CPU at tiny sizes: the ``fit_neumf``
driver end to end through the harness, its check turning false with a fault
planted in the timed path, the operation counts of
``metrics/_counts_neumf.py`` against a hand count, the new per-layer readers
on a recorded trace (and silent where the program opens none of its spans,
as an older program), the matrix-product filter against the operations a
card's step ran, and ``BENCHMARK.json`` checked by
``portbench.spec.validate``."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import spec  # noqa: E402
from portbench.metrics import _counts, _counts_neumf  # noqa: E402
from portbench.tracing import TraceSummary  # noqa: E402

CELL = 'neumf_ml20m.fit_implicit'
NEW_METRICS = ('mfu.neumf', 'mlp_gemm_roofline.neumf', 'step_launches.neumf',
               'step_host_ms.neumf')


#: NeuMF at tiny sizes, D 8: ``packs`` has a (user, item) pair fit 31 bits
#: and the epoch shuffles slots; ``no_pack`` (34,000 users and 32,769 items:
#: 16 item bits) does not, as ML-20M does not, and shuffles the examples
SIZES = {'packs': {'num_users': 1000, 'num_items': 300, 'num_ratings': 30000},
         'no_pack': {'num_users': 34000, 'num_items': 32769, 'num_ratings': 70000}}


def tiny_root(root, size):
    """A checkout in ``root`` holding BENCHMARK.json and ``portbench/``, NeuMF
    cut to ``SIZES[size]`` at D 8, B 4,096 and fits of 3 epochs."""
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    shutil.copytree(REPO / 'portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    path = root / 'portbench' / 'configs' / 'neumf_ml20m.json'
    config = json.loads(path.read_text())
    config.update(embedding_dim=8, batch_size=4096)
    config['data'].update(SIZES[size])
    path.write_text(json.dumps(config))
    path = root / 'portbench' / 'traffic' / 'fit_neumf.json'
    traffic = json.loads(path.read_text())
    traffic['epochs_per_fit'] = 3
    path.write_text(json.dumps(traffic))
    return root


#: a run of the harness in a process of its own (this one holds JAX, which
#: the harness refuses); a fault is planted underneath the trainer first:
#: ``half`` trains each step on half its rows, ``roll`` each step of an
#: epoch on the rows of the step before it
RUN = """
import sys, time
t0 = time.perf_counter()
root, repo, trace, fault = sys.argv[1:5]
sys.path[:0] = [root, repo]
import torch
torch.set_num_threads(2)
from pathlib import Path
from portbench import harness
from collie_tpu_torch.training import scan_engine
if fault == 'half':
    real = scan_engine.train_step

    def half_batch(model, specs, active, params, opt_states, batch, *args):
        mask = batch['mask'].clone()
        mask[mask.shape[0] // 2:] = 0
        return real(model, specs, active, params, opt_states, {**batch, 'mask': mask}, *args)

    scan_engine.train_step = half_batch
if fault == 'roll':
    real_steps = scan_engine.train_steps

    def rolled(model, specs, active, params, opt_states, batches, *args, **kwargs):
        batches = {k: torch.roll(v, 1, dims=0) for k, v in batches.items()}
        return real_steps(model, specs, active, params, opt_states, batches, *args, **kwargs)

    scan_engine.train_steps = rolled
sys.exit(harness.main(['--workload', 'neumf_ml20m.fit_implicit', '--seed', '4294967311',
                       '--seconds', '0.2', '--trace', trace], t0, Path(root),
                      device=torch.device('cpu')))
"""


def run_cell(root, trace=0, fault=''):
    done = subprocess.run([sys.executable, '-c', RUN, str(root), str(REPO), str(trace),
                           fault], capture_output=True, text=True, timeout=300, cwd=root)
    assert done.returncode == 0, done.stderr[-3000:]
    return json.loads(done.stdout.strip().splitlines()[-1]), done.stderr


@pytest.mark.parametrize('size,trace', [('no_pack', 0), ('packs', 1)])
def test_the_neumf_cell_runs_correct(tmp_path, size, trace):
    root = tiny_root(tmp_path, size)
    result, err = run_cell(root, trace)
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 1
    limits = json.loads((root / 'portbench/limits' / f'{CELL}.json').read_text())
    assert set(result['checks']) == set(limits['numbers'])
    assert result['checks']['batch_mismatch']['value'] == 0
    assert 'fused False, fused_tables True, sampler bucketed, selection sparse' in err
    wanted = spec.per_layer_for(spec.load_spec(root), CELL) if trace else \
        spec.end_to_end_for(spec.load_spec(root), CELL)
    names = {m['name'] for m in wanted}
    if trace:
        # the CPU has no device trace: the readers of host spans and clocks answer
        assert {'mfu.neumf', 'step_host_ms.neumf', 'fit_host_ms.train', 'sample_ms.train',
                'fit_syncs.train', 'epoch_tables_ms.train'} <= set(result['metrics'])
        assert set(result['metrics']) <= names
        assert 'mfu.train' not in names and 'epoch_kernel_roofline.train' not in names
    else:
        assert set(result['metrics']) == names == {'train_examples_per_s', 'setup_s'}


def test_a_half_batch_fault_in_the_timed_path_is_not_correct(tmp_path):
    result, _ = run_cell(tiny_root(tmp_path, 'packs'), fault='half')
    assert not result['correct']
    assert result['checks']['batch_mismatch']['value'] == 0
    over = [k for k, c in result['checks'].items() if c['value'] > c['limit']]
    assert {'step_grad_err', 'step_delta_err'} <= set(over)


def test_steps_trained_on_another_steps_rows_are_not_correct(tmp_path):
    """Each step of every epoch fed the rows of the step before it: the
    epochs' batches are right and the reference retraining the rows the
    program was fed would agree, but the held steps' rows are not their
    steps' rows of the reconstructed epoch."""
    result, _ = run_cell(tiny_root(tmp_path, 'packs'), fault='roll')
    assert not result['correct']
    assert result['checks']['batch_mismatch']['value'] > 0


def test_counts_by_hand():
    # D 2, L 2: layers 8->4 and 4->2, the predict layer 4->1
    assert _counts_neumf.mlp_widths(2, 2) == [(8, 4), (4, 2)]
    gemm = 2 * 8 * 4 + 2 * 4 * 2 + 2 * 4                  # 88
    assert _counts_neumf.gemm_flops_per_pair(2, 2) == gemm
    forward = gemm + (4 + 2) + 1 + 2                      # + biases, predict bias, GMF
    assert _counts_neumf.forward_flops_per_pair(2, 2) == forward
    U, I, B, K = 5, 7, 16, 3
    params = (U + I) * (2 + 4) + (8 * 4 + 4) + (4 * 2 + 2) + (4 + 1)
    assert _counts_neumf.num_params(U, I, 2, 2) == params
    step = _counts_neumf.step_counts(U, I, 2, 2, B, K)
    assert step['gemm'] == K * B * gemm + 2 * B * 3 * gemm
    assert step['total'] == K * B * forward + 2 * B * (forward + 2 * gemm) \
        + params * _counts.ADAM_FLOPS
    shape = {'num_users': U, 'num_items': I, 'dim': 2, 'layers': 2, 'batch': B,
             'negatives': K, 'steps': 9}
    assert _counts_neumf.epoch_counts(shape) == {k: 9 * v for k, v in step.items()}
    # the configuration's widths: 31.8M parameters, ~0.823 MFLOP an example
    assert _counts_neumf.mlp_widths(64, 2) == [(256, 128), (128, 64)]
    assert _counts_neumf.num_params(138493, 26744, 64, 2) == 165237 * 192 + 41281
    fwd, gemm = (_counts_neumf.forward_flops_per_pair(64, 2),
                 _counts_neumf.gemm_flops_per_pair(64, 2))
    assert 4 * fwd + 2 * (fwd + 2 * gemm) == 823302


class _Run:
    def __init__(self, inputs, trace):
        self.inputs, self.trace = inputs, trace


def _trace(steps=True):
    """A recorded window of 1 s: two training steps of four operations, two
    of them matrix products."""
    ms = 1_000_000
    host = [('portbench.window', 0, 1000 * ms)]
    device = []
    for s in range(2):
        t = 100 * ms + s * 300 * ms
        if steps:
            host.append(('collie.fit.step', t, t + 10 * ms))
        device += [('ampere_sgemm_128x64_nn', t + 20 * ms, t + 60 * ms),
                   ('void gemv2T_kernel_val<int, int, float>', t + 60 * ms, t + 70 * ms),
                   ('void at::native::elementwise_kernel<128, 4>', t + 70 * ms, t + 80 * ms),
                   ('void at::native::radixSortKVInPlace<2>', t + 80 * ms, t + 130 * ms)]
    return TraceSummary(device, host)


def _read(name, run):
    return spec.metric_module(name).read(run)


def test_the_new_readers_on_a_recorded_trace():
    shape = {'num_users': 10, 'num_items': 20, 'dim': 4, 'layers': 2, 'batch': 8,
             'steps': 2, 'negatives': 3}
    fits = [{'start': 0.0, 'end': 1.0, 'log': [{'seconds': 0.5}]}]
    run = _Run({'fits': fits, 'window_s': 1.0, 'shape': shape}, _trace())
    assert _read('step_launches.neumf', run) == 4.0
    assert _read('step_host_ms.neumf', run) == pytest.approx(10.0)
    gemm = _counts_neumf.epoch_counts(shape)['gemm']
    assert _read('mlp_gemm_roofline.neumf', run) == pytest.approx(
        100 * gemm / _counts.PEAK_FP32_FLOPS / 0.1)            # two 50 ms pairs of products
    assert _read('mfu.neumf', run) == pytest.approx(
        100 * _counts_neumf.epoch_counts(shape)['total'] / _counts.PEAK_FP32_FLOPS)


def test_the_new_readers_are_silent_without_their_spans_or_kernels():
    shape = {'num_users': 10, 'num_items': 20, 'dim': 4, 'layers': 2, 'batch': 8,
             'steps': 2, 'negatives': 3}
    bare = _trace(steps=False)
    fits = {'fits': [{'start': 0.0, 'end': 1.0, 'log': []}], 'window_s': 1.0, 'shape': shape}
    assert _read('step_launches.neumf', _Run(fits, bare)) is None
    assert _read('step_host_ms.neumf', _Run(fits, bare)) is None
    assert _read('mlp_gemm_roofline.neumf', _Run({**fits, 'fits': []}, bare)) is None
    assert _read('mfu.neumf', _Run({**fits, 'fits': []}, None)) is None
    for name in NEW_METRICS:
        assert _read(name, _Run({}, None)) is None


def test_the_gemm_filter_picks_the_products_of_a_recorded_step_alone():
    """Every device operation of a NeuMF training step, as a traced run on
    the card named them (``fixtures/neumf_step_ops.json``): the filter picks
    the matrix products and nothing else."""
    recorded = json.loads((REPO / 'tests/fixtures/neumf_step_ops.json').read_text())
    is_gemm = spec.metric_module('mlp_gemm_roofline.neumf').is_gemm
    assert recorded['products'] and recorded['others']
    assert all(is_gemm(name) for name in recorded['products'])
    assert not any(is_gemm(name) for name in recorded['others'])


def test_the_benchmark_validates_with_the_new_cell():
    loaded = spec.load_spec()
    assert spec.validate(loaded) == []
    cells = {c['name']: c for c in loaded['workloads']}
    assert cells[CELL]['chips'] == 1 and cells[CELL]['config'] == 'neumf_ml20m'
    assert set(NEW_METRICS) <= {m['name'] for m in spec.per_layer_for(loaded, CELL)}
    assert [m['name'] for m in spec.end_to_end_for(loaded, CELL)] == \
        ['train_examples_per_s', 'setup_s']
    config = spec.config_file(loaded, 'neumf_ml20m')
    assert config['reduced'] == [] and config['embedding_dim'] == 64
    assert config['num_layers'] == 2 and np.all(np.asarray(config['assumed'], dtype=object))
