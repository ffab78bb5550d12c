"""The control of each cell's output check comes out as not correct: the
reference put in the program's place one precision step below the
configured float32 (bfloat16 for training, TF32 for serving) fails one of
the cell's limits at least, while the program passes them all.  Also the
planted faults of training (half of every batch left out)."""
import json

import pytest
import torch

from portbench import spec
from portbench.tests.conftest import REPO, TINY, _merge


def _cell(root, name, device):
    loaded = spec.load_spec(root)
    entry = spec.workload(loaded, name)
    config = spec.config_file(loaded, entry['config'], root)
    traffic = spec.traffic_file(entry['traffic'], root)
    limits = spec.limits_file(name, root)['numbers']
    return spec.driver_module(traffic['driver'], root).Cell(config, traffic, 2 ** 35 + 3,
                                                          device), limits


def _fails(numbers, limits, prefix):
    return [k for k, v in limits.items()
            if f'{prefix}.{k}' in numbers and numbers[f'{prefix}.{k}'] > v['limit']]


@pytest.mark.parametrize('name', ['mf_ml10m.fit_implicit', 'mf_ml10m.fit_explicit'])
def test_training_control_and_fault_fail(tiny_root, name):
    cell, limits = _cell(tiny_root, name, torch.device('cpu'))
    cell.setup()
    cell.window(0.0)
    cell.free_program()
    numbers = cell.check(controls=True)
    assert all(numbers[k] <= v['limit'] for k, v in limits.items()), numbers
    assert _fails(numbers, limits, 'control'), numbers
    assert _fails(numbers, limits, 'fault_half_batch'), numbers


@pytest.mark.cuda
@pytest.mark.parametrize('name', ['mf_msd.recommend_batch'])
def test_serving_control_fails_on_the_card(tmp_path, name):
    """TF32 exists on the card only: serve a 200,000-item cut of the
    catalog there, in the cell's 128-user requests, and judge the
    control's answers."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: TF32 is the control')
    import shutil
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path / 'BENCHMARK.json')
    shutil.copytree(REPO / 'portbench', tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    path = tmp_path / 'portbench' / 'configs' / 'mf_msd.json'
    cut = dict(TINY['mf_msd'], num_items=200000)
    path.write_text(json.dumps(_merge(json.loads(path.read_text()), cut)))
    cell, limits = _cell(tmp_path, name, torch.device('cuda', 0))
    cell.setup()
    cell.window(1.0)
    cell.free_program()
    numbers = cell.check(controls=True)
    assert all(numbers[k] <= v['limit'] for k, v in limits.items()), numbers
    assert _fails(numbers, limits, 'control'), numbers
    assert _fails(numbers, limits, 'fault_altered'), numbers
