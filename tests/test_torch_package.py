"""Package rules of the port: it imports neither JAX nor the JAX package,
and no entry point drops to the CPU on its own."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / 'collie_tpu_torch'
PROGRAM_FILES = sorted(PACKAGE.rglob('*.py')) + [ROOT / 'chip_smoke.py']


def _imported_modules(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize('path', PROGRAM_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_neither_jax_nor_the_jax_package(path):
    banned = [name for name in _imported_modules(path)
              if name.split('.')[0] in ('jax', 'jaxlib', 'optax', 'collie_tpu')]
    assert not banned, f'{path.name} imports {banned}'


TRAINING_SLICE = ['ops/shuffle.py', 'ops/device_sampling.py', 'ops/losses.py',
                  'ops/kernels/fused_mf_epoch.py', 'training/optimizers.py',
                  'training/scan_engine.py', 'training/trainer.py', 'weights.py']


@pytest.mark.parametrize('module', TRAINING_SLICE)
def test_training_slice_modules_are_checked(module):
    """The training slice's modules are among the files the import rule
    above covers, and the fused epoch's CUDA source is in the package."""
    assert PACKAGE / module in PROGRAM_FILES
    assert (PACKAGE / 'csrc' / 'fused_mf_epoch.cu').is_file()


def test_every_module_imports_with_jax_and_collie_tpu_blocked():
    modules = ['.'.join(p.relative_to(ROOT).with_suffix('').parts).replace('.__init__', '')
               for p in PACKAGE.rglob('*.py')]
    script = (
        'import sys, importlib\n'
        "for name in ('jax', 'jaxlib', 'optax', 'collie_tpu'):\n"
        '    sys.modules[name] = None\n'
        f'for name in {sorted(modules) + ["chip_smoke"]!r}:\n'
        '    importlib.import_module(name)\n'
        "assert 'torch' in sys.modules\n"
        "print('imported', len(sys.modules))\n")
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('imported')


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def _tiny_train():
    from collie_tpu_torch.data import Interactions

    return Interactions(users=[0, 0, 1, 1, 2], items=[0, 1, 1, 2, 3], num_negative_samples=1)


def test_model_without_gpu_or_map_location_raises(no_cuda):
    from collie_tpu_torch import MatrixFactorizationModel

    with pytest.raises(RuntimeError, match="map_location='cpu'"):
        MatrixFactorizationModel(train=_tiny_train(), embedding_dim=4, seed=0)
    with pytest.raises(RuntimeError, match='CUDA'):
        MatrixFactorizationModel(train=_tiny_train(), embedding_dim=4, seed=0,
                                 map_location='cuda')


def test_loading_without_gpu_or_map_location_raises(no_cuda, tmp_path):
    from collie_tpu_torch import MatrixFactorizationModel

    path = tmp_path / 'model.npz'
    MatrixFactorizationModel(train=_tiny_train(), embedding_dim=4, seed=0,
                             map_location='cpu').save_model(path)
    with pytest.raises(RuntimeError, match='CUDA'):
        MatrixFactorizationModel(load_model_path=path)
    assert MatrixFactorizationModel(load_model_path=path,
                                    map_location='cpu').device.type == 'cpu'


def test_map_location_is_not_a_hyperparameter():
    from collie_tpu_torch import MatrixFactorizationModel

    model = MatrixFactorizationModel(train=_tiny_train(), embedding_dim=4, seed=0,
                                     map_location='cpu')
    assert 'map_location' not in model.hparams
    assert model.device.type == 'cpu'
    assert all(p.device.type == 'cpu' for p in model.parameters())


def _run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, 'chip_smoke.py'], cwd=cwd, capture_output=True,
                          text=True, timeout=120, env=env)


def test_chip_smoke_fails_without_a_card():
    proc = _run_chip_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / 'chip_smoke.py', tmp_path / 'chip_smoke.py')
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
