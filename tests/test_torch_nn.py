"""The port's dense layers (``collie_tpu_torch/ops/nn.py``) against
``collie_tpu/ops/nn.py``.

Same numpy inputs through both packages' ``linear``, ``apply_final_layer``
and ``leaky_relu``: outputs within rtol 1e-5 / atol 1e-6.  The inits draw
from different generators, so they are held to the same layout and names
and to the same distribution: bounds exactly, and the mean and standard
deviation of a 256 x 128 draw within 4 standard errors of the JAX draw's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops import nn as jax_nn
from collie_tpu_torch.ops import nn

RTOL, ATOL = 1e-5, 1e-6
INITS = sorted(nn.LINEAR_INITS)


def _torch_generator(seed=0):
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


@pytest.mark.parametrize('init', INITS)
def test_add_linear_layout_and_names_match_jax(init):
    jax_params, params = {}, {}
    jax_nn.add_linear(jax_params, 'mlp_0', jax.random.PRNGKey(0), 12, 5, init=init)
    nn.add_linear(params, 'mlp_0', _torch_generator(), 12, 5, init=init)
    assert sorted(params) == sorted(jax_params) == ['mlp_0_bias', 'mlp_0_weight']
    for name, value in params.items():
        assert tuple(value.shape) == tuple(jax_params[name].shape)
        assert value.dtype == torch.float32


@pytest.mark.parametrize('init', INITS)
def test_init_distribution_matches_jax(init):
    in_dim, out_dim = 256, 128
    jax_init = getattr(jax_nn, f'{init}_linear_init')
    jax_w, jax_b = (np.asarray(a) for a in jax_init(jax.random.PRNGKey(1), in_dim, out_dim))
    w, b = (a.numpy() for a in nn.LINEAR_INITS[init](_torch_generator(1), in_dim, out_dim))
    n = w.size
    scale = max(jax_w.std(), 1e-12)
    assert abs(w.mean() - jax_w.mean()) < 4 * scale / np.sqrt(n)
    # the standard error of a sample std is std / sqrt(2n)
    assert abs(w.std() - jax_w.std()) < 4 * scale / np.sqrt(2 * n)
    assert np.abs(w).max() <= np.abs(jax_w).max() * 1.05 + 1e-7
    if init in ('trunc_normal', 'kaiming_uniform_relu'):
        assert not b.any() and not jax_b.any()
    else:
        bound = 1.0 / np.sqrt(in_dim)
        assert np.abs(b).max() <= bound and np.abs(jax_b).max() <= bound


def test_trunc_normal_is_fmod_of_a_normal():
    generator = _torch_generator(3)
    w, _ = nn.trunc_normal_linear_init(generator, 64, 64, std=0.5)
    assert np.abs(w.numpy()).max() < 2 * 0.5


def test_linear_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 7, 12)).astype(np.float32)
    w = rng.standard_normal((12, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    ref = jax_nn.linear({'l_weight': jnp.asarray(w), 'l_bias': jnp.asarray(b)}, 'l',
                        jnp.asarray(x))
    out = nn.linear({'l_weight': torch.from_numpy(w), 'l_bias': torch.from_numpy(b)}, 'l',
                    torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('final_layer', [None, 'sigmoid', 'relu', 'leaky_relu', 'tanh'])
def test_apply_final_layer_matches_jax(final_layer):
    x = np.linspace(-3, 3, 41).astype(np.float32)
    jax_layer = jnp.tanh if final_layer == 'tanh' else final_layer
    layer = torch.tanh if final_layer == 'tanh' else final_layer
    ref = jax_nn.apply_final_layer(jnp.asarray(x), jax_layer)
    out = nn.apply_final_layer(torch.from_numpy(x), layer)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_apply_final_layer_rejects_an_unknown_name():
    with pytest.raises(ValueError, match='not valid final layer'):
        nn.apply_final_layer(torch.zeros(3), 'nonsense')


def test_leaky_relu_has_jax_slope():
    x = np.array([-2.0, -0.5, 0.0, 0.5, 2.0], dtype=np.float32)
    np.testing.assert_allclose(nn.leaky_relu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.leaky_relu(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('dim,num_layers', [(8, 1), (10, 2), (32, 2), (30, 3), (7, 5)])
def test_shrinking_mlp_dims_match_jax(dim, num_layers):
    assert nn.shrinking_mlp_dims(dim, num_layers) == jax_nn.shrinking_mlp_dims(dim, num_layers)
