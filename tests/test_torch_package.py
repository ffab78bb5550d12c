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


EXPLICIT_SLICE = ['ops/kernels/fused_mf_epoch.py', 'training/scan_engine.py',
                  'training/trainer.py', 'evaluate.py', 'weights.py']


@pytest.mark.parametrize('module', EXPLICIT_SLICE)
def test_explicit_slice_modules_are_checked(module):
    """The explicit training slice's modules are among the files the import
    rule covers, and its kernel has a C entry in the fused epoch's source."""
    assert PACKAGE / module in PROGRAM_FILES
    source = (PACKAGE / 'csrc' / 'fused_mf_epoch.cu').read_text()
    assert 'extern "C" int collie_fused_mf_explicit_epoch(' in source


def test_gather_scatter_module_is_checked():
    """The binned gather/scatter's module is among the files the import rule
    covers, and its kernel has a C entry in its CUDA source."""
    assert PACKAGE / 'ops/kernels/gather_scatter.py' in PROGRAM_FILES
    source = (PACKAGE / 'csrc' / 'gather_scatter.cu').read_text()
    assert 'extern "C" int collie_binned_gather_scatter(' in source


# how each persistent kernel's C entry launches: the epoch kernels
# cooperatively (their grid barrier needs every block resident), the binned
# gather/scatter as thread-block clusters (it syncs per cluster, never the grid)
PERSISTENT_LAUNCHES = {'fused_mf_epoch.cu': 'cudaLaunchCooperativeKernel(',
                       'gather_scatter.cu': 'cudaLaunchKernelEx('}


@pytest.mark.parametrize('source', ['fused_mf_epoch.cu', 'gather_scatter.cu'])
def test_persistent_kernels_launch_once_and_cooperatively(source):
    """Each C entry of these sources makes one launch of its kind, none
    with <<<...>>>; only the cooperative ones include the grid barrier."""
    text = (PACKAGE / 'csrc' / source).read_text()
    launch = PERSISTENT_LAUNCHES[source]
    assert '<<<' not in text
    assert text.count(launch) == 1
    cooperative = launch == 'cudaLaunchCooperativeKernel('
    assert ('#include "grid_barrier.cuh"' in text) == cooperative
    assert ('grid_sync(' in text) == cooperative
    if not cooperative:
        assert 'cudaLaunchAttributeClusterDimension' in text
        assert 'cluster.sync()' in text and 'map_shared_rank(' in text
    assert (PACKAGE / 'csrc' / 'grid_barrier.cuh').is_file()


ZOO_SLICE = ['ops/embeddings.py', 'ops/nn.py', 'models/base.py',
             'models/matrix_factorization.py', 'models/mlp_matrix_factorization.py',
             'models/nonlinear_matrix_factorization.py',
             'models/neural_collaborative_filtering.py', 'models/deep_fm.py',
             'models/collaborative_metric_learning.py', 'training/scan_engine.py']
MULTI_STAGE_SLICE = ['models/multi_stage.py', 'models/cold_start_matrix_factorization.py',
                     'models/_hybrid_common.py', 'models/hybrid_matrix_factorization.py',
                     'models/hybrid_pretrained_matrix_factorization.py']


@pytest.mark.parametrize('module', ZOO_SLICE + MULTI_STAGE_SLICE)
def test_zoo_slice_modules_are_checked(module):
    """The zoo and multi-stage slices' modules are among the files the
    import rule covers."""
    assert PACKAGE / module in PROGRAM_FILES


ZOO_NAMES = ['MLPMatrixFactorizationModel', 'NonlinearMatrixFactorizationModel',
             'NeuralCollaborativeFiltering', 'DeepFM', 'CollaborativeMetricLearningModel']
MULTI_STAGE_NAMES = ['MultiStagePipeline', 'ColdStartModel', 'HybridModel',
                     'HybridPretrainedModel']
LOSS_NAMES = ['adaptive_bpr_loss', 'adaptive_hinge_loss', 'bpr_loss', 'hinge_loss',
              'warp_loss', 'mse_loss', 'mae_loss', 'ideal_difference_from_metadata']


@pytest.mark.parametrize('name', ZOO_NAMES + MULTI_STAGE_NAMES + LOSS_NAMES)
def test_zoo_and_losses_are_exported_under_the_jax_names(name):
    """Each is exported flat, as in collie_tpu, and is the object its
    defining module holds."""
    import importlib

    import collie_tpu_torch
    from collie_tpu_torch import models
    from collie_tpu_torch.ops import losses

    assert name in collie_tpu_torch.__all__
    source = losses if name in LOSS_NAMES else models
    if source is models:
        assert name in models.__all__
    assert getattr(collie_tpu_torch, name) is getattr(source, name)
    if name in LOSS_NAMES:
        ops = importlib.import_module('collie_tpu_torch.ops')
        assert name in ops.__all__ and getattr(ops, name) is getattr(losses, name)


def test_explicit_evaluation_is_exported():
    import collie_tpu_torch
    from collie_tpu_torch import evaluate

    assert 'explicit_evaluate_in_batches' in collie_tpu_torch.__all__
    assert collie_tpu_torch.explicit_evaluate_in_batches is evaluate.explicit_evaluate_in_batches


TRAINER_SLICE = ['ops/device_sampling.py', 'training/scan_engine.py', 'training/trainer.py',
                 'training/optimizers.py', 'data/loaders.py', 'data/prefetch.py', 'weights.py',
                 'utils.py']
TRAINER_NAMES = ['ApproximateNegativeSamplingInteractionsDataLoader', 'PrefetchLoader',
                 'CollieMinimalTrainer', 'read_checkpoint']


@pytest.mark.parametrize('module', TRAINER_SLICE)
def test_trainer_slice_modules_are_checked(module):
    """The trainer slice's modules are among the files the import rule
    covers and among the modules imported with JAX blocked."""
    assert PACKAGE / module in PROGRAM_FILES
    name = 'collie_tpu_torch.' + module[:-3].replace('/', '.')
    assert name in _package_modules()


@pytest.mark.parametrize('name', TRAINER_NAMES)
def test_trainer_slice_names_are_exported(name):
    import collie_tpu_torch

    assert name in collie_tpu_torch.__all__ and hasattr(collie_tpu_torch, name)


HDF5_SLICE = ['data/interactions.py', 'data/loaders.py', 'utils.py',
              'training/scan_engine.py', 'training/trainer.py']
HDF5_NAMES = ['HDF5Interactions', 'HDF5InteractionsDataLoader', 'write_hdf5_meta',
              'pandas_df_to_hdf5']


@pytest.mark.parametrize('module', HDF5_SLICE)
def test_hdf5_slice_modules_are_checked(module):
    """The out-of-core slice's modules are among the files the import rule
    covers and among the modules imported with JAX (and, below, h5py)
    blocked."""
    assert PACKAGE / module in PROGRAM_FILES
    assert 'collie_tpu_torch.' + module[:-3].replace('/', '.') in _package_modules()


@pytest.mark.parametrize('name', HDF5_NAMES)
def test_hdf5_slice_names_are_exported(name):
    """Exported flat, as ``collie_tpu`` exports them."""
    import collie_tpu_torch
    from collie_tpu_torch import data

    assert name in collie_tpu_torch.__all__ and hasattr(collie_tpu_torch, name)
    if name != 'pandas_df_to_hdf5':
        assert name in data.__all__ and getattr(data, name) is getattr(collie_tpu_torch, name)


PERIPHERY_SLICE = ['movielens/__init__.py', 'movielens/get_data.py', 'movielens/run.py',
                   'movielens/visualize.py', 'training/profiler.py', 'loss.py', 'metrics.py',
                   'model.py', 'interactions.py', 'cross_validation.py', '_lazy_exports.py',
                   'config.py']
PARALLEL_SLICE = ['parallel/__init__.py', 'parallel/mesh.py', 'parallel/distributed.py',
                  'parallel/sharding.py', 'parallel/embedding.py', 'retrieval.py',
                  'evaluate.py', 'parallel/checkpoint.py']


@pytest.mark.parametrize('module', PERIPHERY_SLICE + PARALLEL_SLICE)
def test_periphery_and_parallel_modules_are_checked(module):
    """The periphery's and the parallel tier's modules are among the
    files the import rule covers and among the modules imported with JAX
    and collie_tpu blocked (numpy-only ones such as ``movielens/get_data``
    included: the port keeps its own copies)."""
    assert PACKAGE / module in PROGRAM_FILES
    name = 'collie_tpu_torch.' + module[:-3].replace('/', '.').replace('.__init__', '')
    assert name in _package_modules()


def test_make_mesh_is_a_flat_name():
    import collie_tpu_torch
    from collie_tpu_torch.parallel import mesh

    assert 'make_mesh' in collie_tpu_torch.__all__
    assert collie_tpu_torch.make_mesh is mesh.make_mesh


def test_every_module_imports_with_h5py_blocked():
    """The card's machine has no h5py: every module and ``chip_smoke``
    import without it (the HDF5 tier imports it where it reads or writes
    a store)."""
    script = (
        'import sys, importlib\n'
        "sys.modules['h5py'] = None\n"
        f'for name in {sorted(_package_modules()) + ["chip_smoke"]!r}:\n'
        '    importlib.import_module(name)\n'
        "print('imported')\n")
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith('imported')


def _package_modules():
    return ['.'.join(p.relative_to(ROOT).with_suffix('').parts).replace('.__init__', '')
            for p in PACKAGE.rglob('*.py')]


def test_every_module_imports_with_jax_and_collie_tpu_blocked():
    modules = _package_modules()
    script = (
        'import sys, importlib\n'
        "for name in ('jax', 'jaxlib', 'optax', 'ml_dtypes', 'collie_tpu'):\n"
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
