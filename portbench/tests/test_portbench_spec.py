"""Cells, configurations
and metrics of BENCHMARK.json found by name: one added only as files is loaded and checked
without an edit to the harness."""
import json
import shutil

import pytest

from portbench import harness, spec
from portbench.tests.conftest import REPO


def test_benchmark_file_keeps_the_rules():
    loaded = spec.load_spec(REPO)
    assert spec.validate(loaded, REPO) == []
    assert len(json.dumps(loaded)) < 64 * 1024


def test_every_cell_names_files_that_load():
    loaded = spec.load_spec(REPO)
    for cell in loaded['workloads']:
        traffic = spec.traffic_file(cell['traffic'], REPO)
        assert hasattr(spec.driver_module(traffic['driver'], REPO), 'Cell')
        limits = spec.limits_file(cell['name'], REPO)
        assert limits['numbers']
        for metric in spec.per_layer_for(loaded, cell['name']):
            assert callable(spec.metric_module(metric['name'], REPO).read)


@pytest.fixture
def copy_root(tmp_path):
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(REPO / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    return tmp_path


def test_cell_and_metric_added_as_files(copy_root, capsys):
    """A new traffic mix, limits file and metric reader, plus their
    BENCHMARK.json entries: found, validated and read with no code edited."""
    root = copy_root
    traffic = json.loads((root / 'portbench/traffic/recommend_batch.json').read_text())
    traffic['users_per_request'] = {'min': 1, 'max': 16, 'ladder': 5}
    (root / 'portbench/traffic/recommend_small.json').write_text(json.dumps(traffic))
    shutil.copy(root / 'portbench/limits/mf_msd.recommend_batch.json',
                root / 'portbench/limits/mf_msd.recommend_small.json')
    (root / 'portbench/metrics/requests_seen.serve_small.py').write_text(
        'def read(run):\n    return float(len(run.inputs["requests"]))\n')
    loaded = spec.load_spec(root)
    loaded['workloads'].append({'name': 'mf_msd.recommend_small', 'config': 'mf_msd',
                                'traffic': 'recommend_small', 'chips': 1,
                                'why': '1 to 16 users a request: launch-bound requests'})
    for metric in loaded['end_to_end']:
        if metric['name'] == 'recommend_users_per_s':
            metric['workloads'].append('mf_msd.recommend_small')
    loaded['per_layer'].append({'name': 'requests_seen.serve_small', 'unit': 'requests',
                                'better': 'higher', 'source': 'host_clock', 'layer': 'Entry',
                                'moves': 'recommend_users_per_s',
                                'workloads': ['mf_msd.recommend_small']})
    (root / 'BENCHMARK.json').write_text(json.dumps(loaded))
    assert spec.validate(loaded, root) == []
    assert [m['name'] for m in spec.per_layer_for(loaded, 'mf_msd.recommend_small')] \
        == ['requests_seen.serve_small']
    reader = spec.metric_module('requests_seen.serve_small', root)
    assert reader.read(harness.Run({'requests': [{}, {}]}, None)) == 2.0
    # without a card the measurement path fails: it never falls back to the CPU
    rc = harness.main(['--workload', 'mf_msd.recommend_small', '--seed', '1',
                       '--seconds', '1', '--trace', '0'], 0.0, root)
    out, err = capsys.readouterr()
    assert rc != 0 and out == '' and 'CUDA card' in err


def test_rules_refuse_bad_files(copy_root):
    loaded = spec.load_spec(copy_root)
    loaded['configs'][0]['file'] = 'portbench/configs/no_such.json'
    loaded['per_layer'][0]['moves'] = 'no_such_metric'
    loaded['workloads'].append(dict(loaded['workloads'][0], name='again', traffic='no_such'))
    errors = spec.validate(loaded, copy_root)
    assert any('no file' in e for e in errors)
    assert any('moves unknown' in e for e in errors)
    assert any('no traffic file' in e for e in errors)
