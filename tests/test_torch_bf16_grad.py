"""A bfloat16 table's gradient in the port against collie_tpu's.

collie_tpu gathers a bfloat16 table through ``_bf16_lookup``
(``collie_tpu/ops/embeddings.py:52-73``): its backward sums the rows'
float32 gradients in float32 and rounds to bfloat16 once.  The port's
``embedding_lookup`` does the same through ``_Bf16Lookup``.  The two sum
the same float32 terms in different orders, so a rounded element may land
one bfloat16 step apart: every element must lie within ``BF16_STEP`` of
|ref| (one unit in the last place of bfloat16's 8-bit significand) plus
``CANCEL_SCALE`` of max|ref| (an element whose float32 terms cancel keeps
their rounding, ~1e-11 here), and at most ``MAX_STEPPED`` of the elements
may differ at all.  A table that sums
its collisions in bfloat16 (what the port did before) differs in most
elements, by up to several percent of max|grad|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.data import InteractionsDataLoader as JaxLoader
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu.ops.embeddings import embedding_lookup as jax_lookup
from collie_tpu.training.trainer import CollieTrainer as JaxTrainer
from collie_tpu_torch import (CollieTrainer, InteractionsDataLoader, MatrixFactorizationModel,
                              params_from_jax, stratified_split)
from collie_tpu_torch.data.synthetic import generate_implicit_interactions
from collie_tpu_torch.ops.embeddings import embedding_lookup
from collie_tpu_torch.training import scan_engine

from tests.fixtures.model_fixtures import implicit_sets, implicit_train  # noqa: F401
from tests.test_torch_training import DATA, Recorder, jax_epoch_draws

BF16_STEP = 2.0 ** -7
CANCEL_SCALE = 1e-6
MAX_STEPPED = 0.01


def _grads_close(got: np.ndarray, ref: np.ndarray) -> float:
    """Hold a bfloat16 gradient (as float32) to JAX's; returns the share of
    elements that differ."""
    np.testing.assert_allclose(got, ref, rtol=BF16_STEP, atol=CANCEL_SCALE * np.abs(ref).max())
    stepped = float(np.mean(got != ref))
    assert stepped <= MAX_STEPPED, f'{stepped:.2%} of the elements differ'
    return stepped


@pytest.mark.parametrize('ids_shape', [(65_536,), (8, 4_096)])
def test_lookup_gradient_matches_jax_with_colliding_ids(ids_shape):
    """65,536 lookups into a 64 x 16 table: every row collides ~1,000
    times.  The upstream gradient is the same float32 array in both."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 16)).astype(np.float32)
    ids = rng.integers(0, 64, ids_shape).astype(np.int32)
    upstream = rng.standard_normal(ids_shape + (16,)).astype(np.float32)

    ref = jax.grad(lambda t: jnp.sum(jax_lookup(t, jnp.asarray(ids)) * upstream))(
        jnp.asarray(table, jnp.bfloat16))
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))

    leaf = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    out = embedding_lookup(leaf, torch.from_numpy(ids).long())
    assert out.dtype == torch.float32
    (out * torch.from_numpy(upstream)).sum().backward()
    assert leaf.grad.dtype == torch.bfloat16
    _grads_close(leaf.grad.float().numpy(), ref)

    # the form the port replaced: autograd rounds each row's gradient to
    # bfloat16 and sums the collisions in bfloat16
    naive = torch.from_numpy(table).to(torch.bfloat16).requires_grad_()
    (naive[torch.from_numpy(ids).long()].float() * torch.from_numpy(upstream)).sum().backward()
    assert np.mean(naive.grad.float().numpy() != ref) > 0.5


def test_float32_lookup_is_a_plain_gather():
    table = torch.randn(10, 4, requires_grad=True)
    ids = torch.tensor([1, 1, 3])
    out = embedding_lookup(table, ids)
    out.sum().backward()
    assert torch.equal(out, table[ids])
    assert torch.equal(table.grad[1], torch.full((4,), 2.0))


@pytest.fixture(scope='module')
def bf16_pair():
    from tests.test_torch_training import jax_generate, jax_split

    jax_train, _ = jax_split(jax_generate(**DATA), test_p=0.2, seed=1, force_split=True)
    train, _ = stratified_split(generate_implicit_interactions(**DATA), test_p=0.2, seed=1,
                                force_split=True)
    return jax_train, train


def _models(bf16_pair, **kwargs):
    jax_train, train = bf16_pair
    common = dict(embedding_dim=8, lr=1e-1, loss='adaptive', seed=0,
                  embeddings_dtype='bfloat16', **kwargs)
    jax_model = JaxMF(train=JaxLoader(interactions=jax_train, batch_size=1024, shuffle=True,
                                      seed=0), **common)
    model = MatrixFactorizationModel(
        train=InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True, seed=0),
        map_location='cpu', **common)
    model.load_params(params_from_jax({k: np.asarray(v) for k, v in jax_model.params.items()},
                                      'cpu'))
    return jax_model, model


def test_bf16_mf_step_matches_jax(bf16_pair):
    """One training step of a bfloat16-table MF (the adaptive hinge on its
    default sparse-hardest form, K = 4, masked tail): the loss within
    rtol 1e-5, the float32 bias gradients within rtol 1e-4 / atol 1e-7,
    the bfloat16 table gradients as the module docstring says."""
    jax_model, model = _models(bf16_pair)
    assert model.params['user_embeddings'].dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    B, K = 512, 4
    batch = {'users': rng.integers(0, 250, B).astype(np.int32),
             'pos_items': rng.integers(0, 500, B).astype(np.int32),
             'neg_items': rng.integers(0, 500, (B, K)).astype(np.int32),
             'mask': np.r_[np.ones(B - 7), np.zeros(7)].astype(np.float32)}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: jax_model.calculate_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                                           training=True))(jax_model.params)
    leaves = {k: v.clone().requires_grad_() for k, v in model.params.items()}
    loss = model.calculate_loss(leaves, {k: torch.from_numpy(v) for k, v in batch.items()},
                                training=True)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for name, grad in grads.items():
        ref = np.asarray(ref_grads[name].astype(jnp.float32))
        assert grad.dtype == leaves[name].dtype, name
        if grad.dtype == torch.bfloat16:
            _grads_close(grad.float().numpy(), ref)
        else:
            np.testing.assert_allclose(grad.numpy(), ref, rtol=1e-4, atol=1e-7, err_msg=name)


def test_bf16_training_decreases_loss_and_keeps_dtype(bf16_pair, monkeypatch):
    """Counterpart of ``tests/test_bf16_embeddings.py::
    test_bf16_training_decreases_loss_and_keeps_dtype``: 4 epochs, the
    epoch loss falls, the tables stay bfloat16, every loss is finite.  On
    JAX's epoch draws, each epoch's loss is also within rtol 1e-2 of JAX's
    (bfloat16 tables round every update, so the fits part at that level)."""
    monkeypatch.setattr(scan_engine, 'draw_epoch', jax_epoch_draws)
    jax_model, model = _models(bf16_pair)
    losses = {}
    for name, trainer_cls, m in (('jax', JaxTrainer, jax_model), ('port', CollieTrainer, model)):
        recorder = Recorder()
        trainer_cls(m, max_epochs=4, verbosity=0, logger=recorder, seed=0).fit(m)
        losses[name] = [metrics['train_loss_epoch'] for _, metrics in recorder.metrics
                        if 'train_loss_epoch' in metrics]
    assert len(losses['port']) == 4
    assert losses['port'][-1] < losses['port'][0]
    assert np.isfinite(losses['port']).all()
    assert model.params['user_embeddings'].dtype == torch.bfloat16
    assert model.params['item_embeddings'].dtype == torch.bfloat16
    np.testing.assert_allclose(losses['port'], losses['jax'], rtol=1e-2)
