"""The benchmark's staged hybrid cell on the CPU at tiny sizes: the
``fit_hybrid`` driver end to end through the harness, its check turning
false with a fault planted in the timed path (each step on half its rows;
the frozen tables trained in ``metadata_only``), the item metadata's
generator, the operation counts of ``metrics/_counts_hybrid.py`` against a
hand count, the new per-layer readers on a recorded trace (and silent
where the program has no counter, as an older program), and
``BENCHMARK.json`` checked by ``portbench.spec.validate``."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import spec  # noqa: E402
from portbench.metrics import _counts, _counts_hybrid  # noqa: E402
from portbench.tracing import TraceSummary  # noqa: E402
from portbench.traffic import item_metadata, ratings  # noqa: E402

CELL = 'hybrid_ml20m.fit_staged'
NEW_METRICS = ('meta_gemm_roofline.hybrid', 'mfu.hybrid', 'meta_rows_per_example.hybrid')
STAGES = ['matrix_factorization', 'metadata_only', 'all']


def tiny_root(root):
    """A checkout in ``root`` holding BENCHMARK.json and ``portbench/``, the
    hybrid at D 8, combined layers 16-8, 8 genome tags on 200 movies and 4
    genres, B 4,096, on 34,000 users x 32,769 items (16 item bits: a pair
    does not pack into 31 bits, as ML-20M's does not, so the epoch shuffles
    the examples)."""
    shutil.copy(REPO / 'BENCHMARK.json', root / 'BENCHMARK.json')
    shutil.copytree(REPO / 'portbench', root / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    path = root / 'portbench' / 'configs' / 'hybrid_ml20m.json'
    config = json.loads(path.read_text())
    config.update(embedding_dim=8, batch_size=4096, combined_layers_dims=[16, 8])
    config['data'].update(num_users=34000, num_items=32769, num_ratings=40000)
    config['item_metadata'].update(genome_tags=8, genome_movies=200, genres=4)
    path.write_text(json.dumps(config))
    return root


#: runs of the harness in a process of its own (this one holds JAX, which
#: the harness refuses), one a fault: none (traced), ``half`` (each step
#: trains on half its rows), ``leak`` (``metadata_only`` also steps the MF
#: stage's optimizer of the embedding tables)
RUN = """
import json, sys, time
root, repo = sys.argv[1:3]
sys.path[:0] = [root, repo]
import torch
torch.set_num_threads(2)
from pathlib import Path
from portbench import harness
from collie_tpu_torch.training import scan_engine
real = scan_engine.train_step


def half_batch(model, specs, active, params, opt_states, batch, *args):
    mask = batch['mask'].clone()
    mask[mask.shape[0] // 2:] = 0
    return real(model, specs, active, params, opt_states, {**batch, 'mask': mask}, *args)


def leak(model, specs, active, params, opt_states, batch, *args):
    if model.current_stage == 'metadata_only':
        active = [on or spec.stage == 'matrix_factorization' for spec, on in zip(specs, active)]
    return real(model, specs, active, params, opt_states, batch, *args)


for fault, trace in (('', '1'), ('half', '0'), ('leak', '0')):
    scan_engine.train_step = {'': real, 'half': half_batch, 'leak': leak}[fault]
    rc = harness.main(['--workload', 'hybrid_ml20m.fit_staged', '--seed', '4294967311',
                       '--seconds', '0.2', '--trace', trace], time.perf_counter(), Path(root),
                      device=torch.device('cpu'))
    assert rc == 0, rc
"""


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    root = tiny_root(tmp_path_factory.mktemp('hybrid'))
    done = subprocess.run([sys.executable, '-c', RUN, str(root), str(REPO)],
                          capture_output=True, text=True, timeout=300, cwd=root)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = [json.loads(line) for line in done.stdout.splitlines() if line.startswith('{')]
    assert len(lines) == 3
    return {'root': root, 'stderr': done.stderr, **dict(zip(('traced', 'half', 'leak'), lines))}


def test_the_hybrid_cell_runs_correct(runs):
    result, root = runs['traced'], runs['root']
    assert result['correct'], result['checks']
    assert result['failed'] == 0 and result['attempted'] >= 1
    limits = json.loads((root / 'portbench/limits' / f'{CELL}.json').read_text())
    assert set(result['checks']) == set(limits['numbers'])
    assert result['checks']['batch_mismatch']['value'] == 0
    assert result['checks']['frozen_changed']['value'] == 0
    assert 'fused False, fused_tables False, sampler bucketed, selection sparse' in \
        runs['stderr']
    assert "held steps [[1, 10], [1, 10], [1, 10]]" in runs['stderr']
    names = {m['name'] for m in spec.per_layer_for(spec.load_spec(root), CELL)}
    # the CPU has no device trace: the readers of host spans, clocks and counters answer
    assert {'mfu.hybrid', 'meta_rows_per_example.hybrid', 'fit_host_ms.train',
            'sample_ms.train', 'fit_syncs.train', 'epoch_tables_ms.train',
            'fit_setup_ms.train'} <= set(result['metrics']) <= names
    # 12 rows an example (10 selected, 2 scored again), pad rows included:
    # 10 steps of 4,096 over 40,000 examples
    assert result['metrics']['meta_rows_per_example.hybrid']['value'] == \
        pytest.approx(12 * 10 * 4096 / 40000)


def test_a_half_batch_fault_in_the_timed_path_is_not_correct(runs):
    result = runs['half']
    assert not result['correct']
    assert set(result['metrics']) == {'train_examples_per_s', 'setup_s'}
    assert result['checks']['batch_mismatch']['value'] == 0
    over = {k for k, c in result['checks'].items() if c['value'] > c['limit']}
    assert {'step_grad_err', 'step_delta_err'} <= over


def test_frozen_tables_trained_in_the_metadata_stage_are_not_correct(runs):
    result = runs['leak']
    assert not result['correct']
    over = {k for k, c in result['checks'].items() if c['value'] > c['limit']}
    assert {'frozen_changed', 'step_delta_err'} <= over
    # the embedding tables, in each checked job's metadata_only fit
    assert result['checks']['frozen_changed']['value'] == 4


def test_the_metadata_is_tied_to_the_logs_planted_factors():
    """The generator's item factors are those ``generate_ratings`` drew for
    the seed (its second ``randn``); the genome rows go to the most-rated
    items; relevances lie in [0, 1], and each movie holds 1 to 3 genres."""
    drawn, real = [], torch.randn

    def recording(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(out.clone())
        return out

    torch.randn = recording
    try:
        log = ratings.generate_ratings(300, 200, 4000, 77, 'cpu', latent_dim=4,
                                       affinity_bias=3.0)
    finally:
        torch.randn = real
    factors = item_metadata.planted_item_factors(300, 200, 77, 'cpu', 4)
    assert torch.equal(factors, drawn[1])
    block = {'genome_tags': 16, 'genome_movies': 50, 'genres': 5, 'genres_per_movie': [1, 3],
             'logit_mean': -2.5, 'tag_offset_std': 0.5, 'factor_weight': 0.9, 'noise': 0.8}
    meta = item_metadata.item_metadata(log['items'], factors, block,
                                       torch.Generator().manual_seed(3))
    assert meta.shape == (200, 21) and meta.dtype == torch.float32
    counts = np.bincount(log['items'].numpy(), minlength=200)
    held = (meta[:, :16] != 0).any(dim=1).numpy()
    assert held.sum() == 50
    assert counts[held].min() >= counts[~held].max()
    genome = meta[held, :16]
    assert float(genome.min()) > 0 and float(genome.max()) < 1
    assert 0.05 < float(genome.mean()) < 0.3                # mostly low, as the Tag Genome's
    per_movie = meta[:, 16:].sum(dim=1)
    assert set(per_movie.unique().tolist()) <= {1.0, 2.0, 3.0}
    assert set(meta[:, 16:].unique().tolist()) == {0.0, 1.0}


def test_counts_by_hand():
    shape = {'num_users': 5, 'num_items': 7, 'dim': 2, 'metadata_cols': 3,
             'combined_dims': [4, 2], 'batch': 16, 'negatives': 3, 'steps': 9}
    # layers 7->4, 4->2, 2->1
    assert _counts_hybrid.combined_widths(2, 3, [4, 2]) == [(7, 4), (4, 2), (2, 1)]
    gemm = 2 * 7 * 4 + 2 * 4 * 2 + 2 * 2 * 1                      # 76
    assert _counts_hybrid.gemm_flops_per_pair(2, 3, [4, 2]) == gemm
    forward = gemm + (4 + 2 + 1) + 2                               # + layer biases, id biases
    layers = 7 * 4 + 4 + 4 * 2 + 2 + 2 + 1
    assert _counts_hybrid.combined_params(2, 3, [4, 2]) == layers
    B, K, tables, biases = 16, 3, 12 * 2, 12
    meta = _counts_hybrid.step_counts(shape, 'metadata_only')
    assert meta['gemm'] == K * B * gemm + 2 * B * 3 * gemm
    assert meta['total'] == K * B * forward + 2 * B * (forward + 2 * gemm) \
        + (layers + biases) * _counts.ADAM_FLOPS
    every = _counts_hybrid.step_counts(shape, 'all')
    assert every['total'] - meta['total'] == tables * _counts.ADAM_FLOPS
    mf = _counts_hybrid.step_counts(shape, 'matrix_factorization')
    assert mf == {'gemm': 0.0, 'total': K * B * 6 + 2 * B * (6 + 8)
                  + tables * _counts.ADAM_FLOPS + biases * _counts.SGD_FLOPS}
    assert _counts_hybrid.epoch_counts(shape, 'all') == {k: 9 * v for k, v in every.items()}
    # the configuration's widths: 164,896 multiply-adds a pair, ~5.28 MFLOP
    # of layer products an example at K = 10
    assert _counts_hybrid.gemm_flops_per_pair(30, 1148, [128, 64, 32]) == 2 * 164896
    full = dict(shape, dim=30, metadata_cols=1148, combined_dims=[128, 64, 32], batch=1,
                negatives=10)
    assert _counts_hybrid.step_counts(full, 'all')['gemm'] == 16 * 2 * 164896


class _Run:
    def __init__(self, inputs, trace):
        self.inputs, self.trace = inputs, trace


SHAPE = {'num_users': 10, 'num_items': 20, 'dim': 4, 'metadata_cols': 6,
         'combined_dims': [8, 4], 'batch': 8, 'negatives': 3, 'steps': 2, 'examples': 15}


def _fits():
    return [{'start': 0.0, 'end': 0.3, 'stage': s, 'log': [{'seconds': 0.2}]} for s in STAGES]


def _trace():
    """A recorded window of 1 s: two matrix products of 50 ms and an
    element-wise operation."""
    ms = 1_000_000
    device = [('ampere_sgemm_128x64_nn', 100 * ms, 140 * ms),
              ('void gemv2T_kernel_val<int, int, float>', 140 * ms, 150 * ms),
              ('void at::native::elementwise_kernel<128, 4>', 150 * ms, 160 * ms),
              ('ampere_sgemm_128x64_tn', 400 * ms, 450 * ms)]
    return TraceSummary(device, [('portbench.window', 0, 1000 * ms)])


def _read(name, run):
    return spec.metric_module(name).read(run)


def test_the_new_readers_on_a_recorded_trace():
    inputs = {'fits': _fits(), 'window_s': 1.0, 'shape': SHAPE,
              'counts': {'collie.hybrid.metadata_rows': 150}}
    run = _Run(inputs, _trace())
    gemm = sum(_counts_hybrid.epoch_counts(SHAPE, s)['gemm'] for s in STAGES)
    assert gemm == 2 * _counts_hybrid.epoch_counts(SHAPE, 'all')['gemm']
    assert _read('meta_gemm_roofline.hybrid', run) == pytest.approx(
        100 * gemm / _counts.PEAK_FP32_FLOPS / 0.1)
    total = sum(_counts_hybrid.epoch_counts(SHAPE, s)['total'] for s in STAGES)
    assert _read('mfu.hybrid', run) == pytest.approx(100 * total / _counts.PEAK_FP32_FLOPS)
    # 150 rows over the two metadata epochs' 15 examples each
    assert _read('meta_rows_per_example.hybrid', run) == pytest.approx(5.0)


def test_the_new_readers_are_silent_without_their_counter_or_kernels():
    inputs = {'fits': _fits(), 'window_s': 1.0, 'shape': SHAPE, 'counts': {}}
    assert _read('meta_rows_per_example.hybrid', _Run(inputs, None)) is None
    assert _read('meta_gemm_roofline.hybrid', _Run(inputs, None)) is None
    bare = TraceSummary([('void at::native::elementwise_kernel<128, 4>', 1, 2)],
                        [('portbench.window', 0, 10)])
    assert _read('meta_gemm_roofline.hybrid', _Run(inputs, bare)) is None
    for name in NEW_METRICS:
        assert _read(name, _Run({}, None)) is None


def test_the_benchmark_validates_with_the_new_cell():
    loaded = spec.load_spec()
    assert spec.validate(loaded) == []
    cells = {c['name']: c for c in loaded['workloads']}
    assert cells[CELL]['chips'] == 1 and cells[CELL]['config'] == 'hybrid_ml20m'
    layer = {m['name'] for m in spec.per_layer_for(loaded, CELL)}
    assert set(NEW_METRICS) <= layer
    assert {'fit_host_ms.train', 'sample_ms.train', 'shuffle_ms.train',
            'device_idle_share.train', 'fit_setup_ms.train', 'epoch_tables_ms.train',
            'fit_syncs.train', 'sampler_kernel_ms.train'} <= layer
    assert [m['name'] for m in spec.end_to_end_for(loaded, CELL)] == \
        ['train_examples_per_s', 'setup_s']
    config = spec.config_file(loaded, 'hybrid_ml20m')
    assert config['reduced'] == [] and config['model'] == 'HybridModel'
    assert config['embedding_dim'] == 30 and config['combined_layers_dims'] == [128, 64, 32]
    assert config['stages'] == STAGES and config['batch_size'] == 65536
    meta = config['item_metadata']
    assert meta['genome_tags'] + meta['genres'] == 1148 and meta['genome_movies'] == 10381
    assert config['data'] == spec.config_file(loaded, 'neumf_ml20m')['data']
    traffic = spec.traffic_file(cells[CELL]['traffic'])
    assert traffic['num_negative_samples'] == 10 and traffic['epochs_per_fit'] == 1
