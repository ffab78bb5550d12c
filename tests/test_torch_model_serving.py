"""The port's MF model against collie_tpu's with the same params.

Params are made with numpy from a seed, installed in the JAX model and
carried to the port with ``params_from_jax``; scores must agree to 1e-5,
hyperparameters must be equal, and an npz saved by either package must load
in the other with identical arrays.
"""
import inspect
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.data import stratified_split as jax_split
from collie_tpu.data.synthetic import generate_implicit_interactions as jax_generate
from collie_tpu.models.matrix_factorization import MatrixFactorizationModel as JaxMF
from collie_tpu_torch import MatrixFactorizationModel, params_from_jax, stratified_split
from collie_tpu_torch.data.synthetic import generate_implicit_interactions

DATA = dict(num_users=60, num_items=240, num_interactions=3000, seed=3)


@pytest.fixture(scope='module')
def trains():
    jax_train, _ = jax_split(jax_generate(**DATA), test_p=0.2, seed=1, force_split=True)
    train, _ = stratified_split(generate_implicit_interactions(**DATA), test_p=0.2, seed=1,
                                force_split=True)
    return jax_train, train


def _pair(trains, seed=0, **kwargs):
    """A JAX MF with numpy-drawn params and the port's MF carrying them."""
    jax_model = JaxMF(train=trains[0], embedding_dim=8, seed=0, **kwargs)
    rng = np.random.default_rng(seed)
    jax_model.params = {
        k: jnp.asarray(rng.standard_normal(np.shape(v)).astype(np.float32) * 0.5)
        .astype(v.dtype) for k, v in jax_model.params.items()}
    model = MatrixFactorizationModel(train=trains[1], embedding_dim=8, seed=0,
                                     map_location='cpu', **kwargs)
    model.load_params(params_from_jax(
        {k: np.asarray(v) for k, v in jax_model.params.items()}, 'cpu'))
    return jax_model, model


def _numpy_params(model):
    return {k: v.float().numpy() for k, v in model.params.items()}


@pytest.mark.parametrize('y_range', [None, (1.0, 5.0)])
def test_scores_match(trains, y_range):
    jax_model, model = _pair(trains, y_range=y_range)
    rng = np.random.default_rng(1)
    users = rng.integers(0, 60, 50)
    items = rng.integers(0, 240, 50)
    block_items = rng.permutation(240)[:37]
    t_users, t_items = torch.from_numpy(users), torch.from_numpy(items)

    np.testing.assert_allclose(
        model.score(model.params, t_users, t_items).numpy(),
        np.asarray(jax_model.score(jax_model.params, jnp.asarray(users), jnp.asarray(items))),
        atol=1e-5)
    np.testing.assert_allclose(model(users, items), jax_model(users, items), atol=1e-5)
    np.testing.assert_allclose(
        model.score_all_items(model.params, t_users[:9]).numpy(),
        np.asarray(jax_model.score_all_items(jax_model.params, jnp.asarray(users[:9]))),
        atol=1e-5)
    np.testing.assert_allclose(
        model.score_item_block(model.params, t_users[:7],
                               torch.from_numpy(block_items)).numpy(),
        np.asarray(jax_model.score_item_block(jax_model.params, jnp.asarray(users[:7]),
                                              jnp.asarray(block_items))),
        atol=1e-5)


def test_base_score_hooks_match_the_mf_overrides(trains):
    """The base pipeline's pairwise hooks compute what MF's matmuls do."""
    from collie_tpu_torch.models.base import BasePipeline

    _, model = _pair(trains)
    users = torch.tensor([0, 5, 59])
    items = torch.tensor([3, 100, 239, 7])
    torch.testing.assert_close(BasePipeline.score_item_block(model, model.params, users, items),
                               model.score_item_block(model.params, users, items))
    torch.testing.assert_close(BasePipeline.score_all_items(model, model.params, users),
                               model.score_all_items(model.params, users))


def test_prediction_and_similarity_apis_match(trains):
    jax_model, model = _pair(trains)
    for a, b in ((jax_model.get_item_predictions(4, unseen_items_only=True),
                  model.get_item_predictions(4, unseen_items_only=True)),
                 (jax_model.get_user_predictions(17), model.get_user_predictions(17)),
                 (jax_model.item_item_similarity(9), model.item_item_similarity(9)),
                 (jax_model.user_user_similarity(2), model.user_user_similarity(2))):
        np.testing.assert_array_equal(b.index.values[:20], a.index.values[:20])
        np.testing.assert_allclose(b.values, a.values, atol=1e-5)
    with pytest.raises(ValueError, match='is not in the model'):
        model.get_item_predictions(60)


def test_hparams_and_param_names_match(trains):
    jax_model, model = _pair(trains, lr=0.05, y_range=(0.0, 1.0), loss='adaptive')
    assert dict(model.hparams) == dict(jax_model.hparams)
    assert sorted(model.state_dict()) == sorted(jax_model.params)
    for name, value in model.state_dict().items():
        assert tuple(value.shape) == tuple(jax_model.params[name].shape)


@pytest.mark.parametrize('loss,negatives', [
    ('hinge', 1), ('hinge', 3), ('adaptive', 3), ('adaptive_bpr', 1), ('bpr', 4),
    ('warp', 3), ('mse', 3), ('mae', 1),
])
def test_loss_configuration_matches(trains, loss, negatives):
    from collie_tpu_torch.data import InteractionsDataLoader
    import collie_tpu.data as jdata

    results = []
    for train, cls, loader_cls in ((trains[0], JaxMF, jdata.InteractionsDataLoader),
                                   (trains[1], MatrixFactorizationModel,
                                    InteractionsDataLoader)):
        train.num_negative_samples = negatives
        kwargs = {} if cls is JaxMF else {'map_location': 'cpu'}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            m = cls(train=loader_cls(train), embedding_dim=4, loss=loss, seed=1, **kwargs)
        results.append((m.hparams['_is_implicit'], [str(w.message) for w in caught],
                        getattr(m.loss_function, '__name__', m.loss_function)))
        train.num_negative_samples = 10
    assert results[0][:2] == results[1][:2]
    assert results[0][2].replace('_loss', '') == results[1][2]


@pytest.mark.parametrize('loss,negatives', [('warp', 1), ('nonsense', 2)])
def test_loss_configuration_errors_match(trains, loss, negatives):
    messages = []
    for train, kwargs in ((trains[0], {}), (trains[1], {'map_location': 'cpu'})):
        cls = JaxMF if not kwargs else MatrixFactorizationModel
        train.num_negative_samples = negatives
        try:
            with pytest.raises(ValueError) as err:
                cls(train=train, embedding_dim=4, loss=loss, seed=1, **kwargs)
        finally:
            train.num_negative_samples = 10
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_jax_npz_loads_in_the_port(trains, tmp_path):
    jax_model, _ = _pair(trains, y_range=(1.0, 5.0))
    path = tmp_path / 'jax_model.npz'
    jax_model.save_model(path)
    model = MatrixFactorizationModel(load_model_path=path, map_location='cpu')
    assert dict(model.hparams) == dict(JaxMF(load_model_path=path).hparams)
    assert model.hparams['load_model_path'] == str(path)
    for name, value in jax_model.params.items():
        np.testing.assert_array_equal(model.params[name].numpy(), np.asarray(value))
    users = np.arange(10)
    np.testing.assert_allclose(model(users, users + 3), jax_model(users, users + 3), atol=1e-5)


def test_port_npz_loads_in_jax(trains, tmp_path):
    model = MatrixFactorizationModel(train=trains[1], embedding_dim=6, seed=4,
                                     map_location='cpu')
    path = tmp_path / 'port_model.npz'
    model.save_model(path)
    jax_model = JaxMF(load_model_path=path)
    reloaded = MatrixFactorizationModel(load_model_path=path, map_location='cpu')
    assert dict(jax_model.hparams) == dict(reloaded.hparams)
    for name, value in _numpy_params(model).items():
        np.testing.assert_array_equal(np.asarray(jax_model.params[name]), value)
        np.testing.assert_array_equal(reloaded.params[name].numpy(), value)


def test_bfloat16_tables_round_trip_both_ways(trains, tmp_path):
    jax_model, model = _pair(trains, embeddings_dtype='bfloat16')
    assert model.params['item_embeddings'].dtype == torch.bfloat16
    assert model.params['item_biases'].dtype == torch.float32
    for name, value in jax_model.params.items():
        np.testing.assert_array_equal(_numpy_params(model)[name],
                                      np.asarray(value, dtype=np.float32))
    path = tmp_path / 'bf16.npz'
    model.save_model(path)
    back = JaxMF(load_model_path=path)
    for name, value in jax_model.params.items():
        assert back.params[name].dtype == value.dtype
        np.testing.assert_array_equal(np.asarray(back.params[name], dtype=np.float32),
                                      np.asarray(value, dtype=np.float32))
    np.testing.assert_allclose(model.score_all_items(model.params, torch.arange(5)).numpy(),
                               np.asarray(jax_model.score_all_items(jax_model.params,
                                                                    jnp.arange(5))),
                               atol=1e-5)


def test_init_is_seeded_and_shaped(trains):
    a = MatrixFactorizationModel(train=trains[1], embedding_dim=5, seed=7, map_location='cpu')
    b = MatrixFactorizationModel(train=trains[1], embedding_dim=5, seed=7, map_location='cpu')
    for name, value in a.params.items():
        assert torch.equal(value, b.params[name])
    emb = a.params['item_embeddings']
    assert emb.shape == (240, 5) and abs(float(emb.std()) - 1 / 12.5) < 0.01
    assert not a.params['user_biases'].any()


@pytest.mark.parametrize('make', [
    lambda m: m.ReduceLROnPlateau(patience=1),
    lambda m: m.ReduceLROnPlateau(factor=0.5, patience=0, threshold=0.1),
    lambda m: m.StepLR(step_size=2, gamma=0.3),
])
def test_schedulers_step_like_jax(make):
    """MF's default ``lr_scheduler_func`` and its siblings decide the same
    lr factors as the JAX package's host schedulers."""
    import collie_tpu.training.schedulers as jax_schedulers
    import collie_tpu_torch.training.schedulers as schedulers

    losses = [1.0, 0.9, 0.95, 0.96, 0.5, 0.5, 0.5, 0.49, 0.6]
    jax_sched = jax_schedulers.resolve_scheduler(make(jax_schedulers))
    sched = schedulers.resolve_scheduler(make(schedulers))
    assert [jax_sched.step(x) for x in losses] == [sched.step(x) for x in losses]
    factory = inspect.signature(MatrixFactorizationModel).parameters['lr_scheduler_func'].default
    assert isinstance(schedulers.resolve_scheduler(factory), schedulers.ReduceLROnPlateau)
