"""Shared fixtures: a copy of the benchmark at tiny sizes, for CPU runs."""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: the configurations cut to what a CPU test holds; the implicit log keeps
#: enough examples that the bucket padding stays under 2% (the program's
#: slot-domain epoch, the path the card takes)
TINY = {
    'mf_ml10m': {'embedding_dim': 8,
                 'data': {'num_users': 20000, 'num_items': 2000, 'num_ratings': 1000000}},
    'mf_msd': {'num_users': 3000, 'num_items': 20000, 'num_interactions': 60000},
}


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for key, value in extra.items():
        out[key] = _merge(base[key], value) if isinstance(value, dict) else value
    return out


@pytest.fixture
def tiny_root(tmp_path, monkeypatch):
    """A checkout holding BENCHMARK.json and ``portbench/`` with the
    configurations cut to TINY, the fits to 3 epochs and the requests to
    4-64 users, and a cell with the seen filter added as files
    (``mf_msd.recommend_seen``); the CPU takes the fused epoch's plain
    version and the kernel's top-k route."""
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(REPO / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    for name, cut in TINY.items():
        path = tmp_path / 'portbench' / 'configs' / f'{name}.json'
        path.write_text(json.dumps(_merge(json.loads(path.read_text()), cut)))
    for path in (tmp_path / 'portbench' / 'traffic').glob('*.json'):
        traffic = json.loads(path.read_text())
        if traffic['driver'] == 'fit':
            traffic['epochs_per_fit'] = 3
        else:
            traffic['users_per_request'].update(min=4, max=64, ladder=5)
        path.write_text(json.dumps(traffic))
    _add_seen_filter_cell(tmp_path)
    monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', '1')
    monkeypatch.setenv('COLLIE_TPU_RETRIEVAL_DENSE_BUDGET_MB', '1')
    return tmp_path


def _add_seen_filter_cell(root):
    """The serving driver's ``filter_seen`` traffic as a cell of its own,
    added by files and BENCHMARK.json entries alone."""
    traffic = json.loads((root / 'portbench/traffic/recommend_batch.json').read_text())
    traffic.update(filter_seen=True, checked_requests=16)
    (root / 'portbench/traffic/recommend_seen.json').write_text(json.dumps(traffic))
    shutil.copy(root / 'portbench/limits/mf_msd.recommend_batch.json',
                root / 'portbench/limits/mf_msd.recommend_seen.json')
    spec = json.loads((root / 'BENCHMARK.json').read_text())
    spec['workloads'].append({'name': 'mf_msd.recommend_seen', 'config': 'mf_msd',
                              'traffic': 'recommend_seen', 'chips': 1,
                              'why': 'the batch job with the seen filter'})
    for metric in spec['end_to_end'] + spec['per_layer']:
        if 'mf_msd.recommend_batch' in metric.get('workloads', []):
            metric['workloads'].append('mf_msd.recommend_seen')
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
