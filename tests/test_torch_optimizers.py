"""The port's hand-written optimizers against collie_tpu's optax chains.

N steps of sgd / adagrad / adam / sparse_adam, with and without weight
decay and with a learning-rate change halfway, on shared grads: params must
match optax to 1e-6 (float32; Adam's bias corrections are both float32
``pow``), optimizer states and counts too, and ``optimizer_state_from_jax``
must carry an optax state into the port exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.training.optimizers import build_transform as jax_build
from collie_tpu.training.optimizers import set_lr as jax_set_lr
from collie_tpu_torch.training.optimizers import (OptState, build_transform, get_lr, set_lr,
                                                  split_bias_keys)
from collie_tpu_torch.weights import optimizer_state_from_jax


def _params(rng):
    return {'user_embeddings': rng.normal(size=(6, 4)).astype(np.float32),
            'item_biases': rng.normal(size=(9,)).astype(np.float32)}


def _run_both(name, wd, steps=6, bf16=False):
    rng = np.random.default_rng(7)
    p = _params(rng)
    j_tx, t_tx = jax_build(name, 0.1, wd), build_transform(name, 0.1, wd)
    dtype = torch.bfloat16 if bf16 else torch.float32
    jp = {k: jnp.asarray(v).astype(jnp.bfloat16 if bf16 else jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v).to(dtype) for k, v in p.items()}
    js, ts = j_tx.init(jp), t_tx.init(tp)
    for i in range(steps):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p.items()}
        ju, js = j_tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = {k: jp[k] + ju[k] for k in jp}
        tu, ts = t_tx.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        tp = {k: tp[k] + tu[k] for k in tp}
        if i == steps // 2:
            js, ts = jax_set_lr(js, 0.03), set_lr(ts, 0.03)
    return jax.device_get(jp), jax.device_get(js), tp, ts


@pytest.mark.parametrize('name', ['sgd', 'adagrad', 'adam', 'sparse_adam'])
@pytest.mark.parametrize('wd', [0.0, 1e-2])
def test_steps_match_optax(name, wd):
    jp, js, tp, ts = _run_both(name, wd)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    carried = optimizer_state_from_jax(js, 'cpu')
    assert carried.count == ts.count == 6
    assert carried.learning_rate == ts.learning_rate == get_lr(ts)
    if name in ('adam', 'sparse_adam'):
        assert int(carried.adam_count) == int(ts.adam_count) == 6
        for k in jp:
            np.testing.assert_allclose(ts.mu[k].numpy(), carried.mu[k].numpy(), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), carried.nu[k].numpy(), rtol=1e-6,
                                       atol=1e-9)
    if name == 'adagrad':
        for k in jp:
            np.testing.assert_allclose(ts.sum_of_squares[k].numpy(),
                                       carried.sum_of_squares[k].numpy(), rtol=1e-6)


def test_bf16_storage_keeps_f32_moments():
    jp, js, tp, ts = _run_both('adam', 0.0, bf16=True)
    for k in jp:
        assert tp[k].dtype == torch.bfloat16 and ts.mu[k].dtype == torch.float32
        np.testing.assert_allclose(tp[k].float().numpy(), np.asarray(jp[k]).astype(np.float32),
                                   rtol=1e-2, atol=1e-2)


def test_weight_decay_is_coupled_and_sparse_adam_drops_it():
    tx = build_transform('sgd', lr=1.0, weight_decay=0.5)
    params = {'w': torch.full((2,), 2.0)}
    updates, _ = tx.update({'w': torch.zeros(2)}, tx.init(params), params)
    torch.testing.assert_close(updates['w'], torch.full((2,), -1.0))
    assert build_transform('sparse_adam', 0.1, weight_decay=0.5).weight_decay == 0.0


def test_set_lr_stores_float32_and_invalid_optimizer_raises():
    state = build_transform('adam', 0.1).init({'w': torch.ones(3)})
    assert isinstance(state, OptState)
    new = set_lr(state, 0.1 / 3)
    assert get_lr(new) == float(np.float32(0.1 / 3)) and get_lr(state) == float(np.float32(0.1))
    with pytest.raises(ValueError, match='not a valid optimizer'):
        build_transform('nonsense', lr=0.1)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        build_transform(lambda **kw: None, lr=0.1)


def test_split_bias_keys():
    bias, rest = split_bias_keys(['user_embeddings', 'item_biases', 'mlp_0_bias',
                                  'mlp_0_weight'])
    assert bias == ['item_biases', 'mlp_0_bias']
    assert rest == ['user_embeddings', 'mlp_0_weight']


def test_model_optimizer_specs_match_jax():
    from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
    from collie_tpu_torch import Interactions, MatrixFactorizationModel
    from collie_tpu.data import Interactions as JaxInteractions

    kw = dict(users=[0, 0, 1, 1, 2], items=[0, 1, 1, 2, 3], num_negative_samples=1)
    for extra in ({}, {'bias_lr': 'infer'}, {'bias_optimizer': 'infer'},
                  {'bias_optimizer': None}, {'optimizer': 'sparse_adam', 'weight_decay': 0.1}):
        j = JaxMF(train=JaxInteractions(**kw), embedding_dim=4, seed=0, **extra)
        t = MatrixFactorizationModel(train=Interactions(**kw), embedding_dim=4, seed=0,
                                     map_location='cpu', **extra)
        j_specs, t_specs = j.optimizer_specs(), t.optimizer_specs()
        assert [(s.name, s.keys) for s in t_specs] == [(s.name, s.keys) for s in j_specs]
        for js, ts in zip(j_specs, t_specs):
            state = js.transform.init({k: jnp.asarray(np.asarray(j.params[k]))
                                       for k in js.keys})
            assert ts.transform.init({k: t.params[k] for k in ts.keys}).learning_rate == \
                float(np.asarray(state.hyperparams['learning_rate']))
