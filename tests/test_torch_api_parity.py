"""Import-surface parity of the port with collie_tpu.

``tests/test_api_parity.py``'s names (the flat namespace and the
reference's submodule paths ``model``, ``interactions``, ``loss``,
``metrics``, ``cross_validation``, ``movielens``) resolve on
``collie_tpu_torch``; ``_lazy_exports.EXPORTS`` has JAX's keys, each
resolving to the port's object; importing the package does not import
``parallel``; the reference quickstart runs with ``map_location='cpu'``.
"""
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

import collie_tpu._lazy_exports as jax_lazy_exports
import collie_tpu_torch
from collie_tpu_torch import _lazy_exports

from tests.test_api_parity import FLAT_EXPORTS, SUBMODULE_EXPORTS

ROOT = Path(__file__).resolve().parents[1]
SHIMS = ['loss', 'metrics', 'model', 'interactions', 'cross_validation', 'movielens']


@pytest.mark.parametrize('name', FLAT_EXPORTS)
def test_flat_export(name):
    assert getattr(collie_tpu_torch, name) is not None
    assert name in collie_tpu_torch.__all__


@pytest.mark.parametrize('module,names', SUBMODULE_EXPORTS.items())
def test_submodule_exports(module, names):
    mod = importlib.import_module(module.replace('collie_tpu', 'collie_tpu_torch', 1))
    for name in names:
        assert getattr(mod, name) is not None, f'{mod.__name__}.{name} missing'


@pytest.mark.parametrize('shim', SHIMS)
def test_shims_export_jax_names(shim):
    """Each path exports JAX's ``__all__``, and each name is the object of
    the port module that defines it."""
    jax_mod = importlib.import_module(f'collie_tpu.{shim}')
    mod = importlib.import_module(f'collie_tpu_torch.{shim}')
    assert sorted(mod.__all__) == sorted(jax_mod.__all__)
    for name in mod.__all__:
        defining = getattr(mod, name)
        home = importlib.import_module(getattr(defining, '__module__', mod.__name__))
        assert getattr(home, name, defining) is defining


@pytest.mark.parametrize('name', sorted(jax_lazy_exports.EXPORTS))
def test_lazy_exports_resolve_to_the_port(name):
    assert set(_lazy_exports.EXPORTS) == set(jax_lazy_exports.EXPORTS)
    expected = jax_lazy_exports.EXPORTS[name].replace('collie_tpu', 'collie_tpu_torch', 1)
    assert _lazy_exports.EXPORTS[name] == expected
    assert getattr(collie_tpu_torch, name) is _lazy_exports.resolve(name)


def test_unknown_attribute_raises():
    with pytest.raises(AttributeError, match='no attribute'):
        collie_tpu_torch.not_a_name  # noqa: B018


def test_make_mesh_is_resolved_lazily():
    script = ('import sys, collie_tpu_torch\n'
              "assert 'collie_tpu_torch.parallel' not in sys.modules\n"
              'from collie_tpu_torch.parallel.mesh import make_mesh\n'
              'assert collie_tpu_torch.make_mesh is make_mesh\n'
              "print('lazy')\n")
    proc = subprocess.run([sys.executable, '-c', script], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'lazy'


def test_reference_quickstart_shape():
    """``tests/test_api_parity.py``'s quickstart with the package renamed
    and the model on the CPU."""
    import numpy as np
    from collie_tpu_torch.cross_validation import stratified_split
    from collie_tpu_torch.interactions import Interactions
    from collie_tpu_torch.metrics import auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.model import CollieTrainer, MatrixFactorizationModel

    rng = np.random.default_rng(0)
    users = np.concatenate([np.arange(100), rng.integers(0, 100, 3000)])
    items = np.concatenate([rng.integers(0, 200, 100), np.arange(200),
                            rng.integers(0, 200, 2800)])
    keys = users * 200 + items
    _, keep = np.unique(keys, return_index=True)
    interactions = Interactions(users=users[keep], items=items[keep],
                                check_num_negative_samples_is_valid=False, seed=0)
    train, test = stratified_split(interactions, test_p=0.2, seed=0,
                                   force_split=True)
    model = MatrixFactorizationModel(train=train, embedding_dim=10, lr=1e-1,
                                     loss='adaptive', seed=0, map_location='cpu')
    trainer = CollieTrainer(model, max_epochs=2, verbosity=0)
    trainer.fit(model)
    scores = evaluate_in_batches([mapk, mrr, auc], test, model, verbose=False)
    assert len(scores) == 3
