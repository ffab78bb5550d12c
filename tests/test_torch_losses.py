"""The port's losses against collie_tpu's.

Values and gradients (w.r.t. the positive and negative scores) of every
loss must match JAX's on shared inputs to ``rtol=1e-5`` (float32 sums taken
in another order), and the reference fixture constants of
``tests/test_losses.py`` must hold to 3 decimals as there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_almost_equal, assert_array_equal

import collie_tpu.ops.losses as J
from collie_tpu_torch.ops import losses as T

# the reference fixture (tests/test_losses.py)
SCORES = np.array([
    1.1, 1.3, 4.7, -7.234,
    -1.3, 0.7, 4.7, -2.2468,
    -4.7, 1.3, 3.56, -0.8924,
    4.01, 2.7, 3.7, -5.2468,
    3.89, 12.8, -1.7, -0.8143,
], dtype=np.float32)
POSITIVE_ITEMS = np.array([0, 1, 2, 3])
NEGATIVE_ITEMS = np.array([4, 5, 6, 7])
MANY_NEGATIVE_ITEMS = np.array([[4, 5, 6, 7], [8, 9, 10, 11], [12, 13, 14, 15],
                                [16, 17, 18, 19]])
POS = torch.from_numpy(SCORES[POSITIVE_ITEMS])
NEG = torch.from_numpy(SCORES[NEGATIVE_ITEMS])
MANY = torch.from_numpy(SCORES[MANY_NEGATIVE_ITEMS])
METADATA_A = np.array([0, 1, 1, 2, 0, 0, 0, 1, 2, 1, 1, 2, 0, 0, 1, 2, 0, 0, 1, 2])
METADATA_B = np.array([1, 2, 2, 3, 3, 2, 1, 3, 3, 2, 2, 2, 1, 1, 2, 2, 1, 1, 2, 2])
META_AB = {'a': torch.from_numpy(METADATA_A), 'b': torch.from_numpy(METADATA_B)}
META_AB_W = {'a': 0.2, 'b': 0.3}


def test_ideal_difference_fixture():
    ideal = T.ideal_difference_from_metadata(
        torch.from_numpy(np.tile(POSITIVE_ITEMS, (4, 1))), torch.from_numpy(MANY_NEGATIVE_ITEMS),
        META_AB, META_AB_W)
    expected = np.array([[.8, .7, 1, .7], [1, .5, .5, .8], [.5, 1, .5, .8], [.5, 1, .5, .8]],
                        dtype=np.float32)
    assert_array_equal(np.round(ideal.numpy(), 5), expected)
    with pytest.raises(ValueError, match='must be <=1'):
        T.ideal_difference_from_metadata(torch.from_numpy(POSITIVE_ITEMS),
                                         torch.from_numpy(NEGATIVE_ITEMS), META_AB,
                                         {'a': .2, 'b': .9})


@pytest.mark.parametrize('fn,args,kwargs,expected', [
    (T.bpr_loss, (POS, NEG), {}, (1.93074 + 1.36897) / 4),
    (T.hinge_loss, (POS, NEG), {}, (7.3872 + 37.00656384) / 4),
    (T.adaptive_bpr_loss, (POS, MANY), {}, 6.592 / 4),
    (T.adaptive_hinge_loss, (POS, MANY), {}, 252.420 / 4),
    (T.warp_loss, (POS, MANY), {'num_items': 4}, (11.366 + 72.385) / 4),
    (T.bpr_loss, (POS, NEG), {'positive_items': torch.from_numpy(POSITIVE_ITEMS),
                              'negative_items': torch.from_numpy(NEGATIVE_ITEMS),
                              'metadata': {'a': META_AB['a']}, 'metadata_weights': {'a': 0.2}},
     (1.73073 + 1.37570) / 4),
    (T.adaptive_bpr_loss, (POS, MANY), {'positive_items': torch.from_numpy(POSITIVE_ITEMS),
                                        'negative_items': torch.from_numpy(MANY_NEGATIVE_ITEMS),
                                        'metadata': META_AB, 'metadata_weights': META_AB_W},
     (2.746 + 2.088) / 4),
    (T.adaptive_hinge_loss, (POS, MANY), {'positive_items': torch.from_numpy(POSITIVE_ITEMS),
                                          'negative_items': torch.from_numpy(MANY_NEGATIVE_ITEMS),
                                          'metadata': META_AB, 'metadata_weights': META_AB_W},
     61.2829),
    (T.warp_loss, (POS, MANY), {'num_items': 4,
                                'positive_items': torch.from_numpy(POSITIVE_ITEMS),
                                'negative_items': torch.from_numpy(MANY_NEGATIVE_ITEMS),
                                'metadata': META_AB, 'metadata_weights': META_AB_W},
     (10.390 + 65.063) / 4),
])
def test_reference_fixture_constants(fn, args, kwargs, expected):
    assert_almost_equal(float(fn(*args, **kwargs)), expected, decimal=3)


def test_sample_weights_mask_out_padding():
    padded_pos = torch.cat([POS[:3], POS[:1]])
    padded_neg = torch.cat([NEG[:3], NEG[:1]])
    masked = T.hinge_loss(padded_pos, padded_neg, sample_weights=torch.tensor([1., 1., 1., 0.]))
    assert_almost_equal(float(masked), float(T.hinge_loss(POS[:3], NEG[:3])), decimal=5)
    assert float(T.warp_loss(torch.full((4,), 100.0), MANY, num_items=1000)) == 0.0


def _inputs(seed, K, B=32, num_items=40):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal(B).astype(np.float32)
    negs = rng.standard_normal((K, B)).astype(np.float32)
    pos_items = rng.integers(0, num_items, B)
    neg_items = rng.integers(0, num_items, (K, B))
    mask = (rng.random(B) > 0.2).astype(np.float32)
    meta = {'a': rng.integers(0, 3, num_items), 'b': rng.integers(0, 4, num_items)}
    return pos, negs, pos_items, neg_items, mask, meta


LOSS_NAMES = ['bpr', 'hinge', 'adaptive_bpr', 'adaptive_hinge', 'warp']


@pytest.mark.parametrize('name', LOSS_NAMES)
@pytest.mark.parametrize('with_meta', [False, True])
def test_values_and_grads_match_jax(name, with_meta):
    K = 1 if name in ('bpr', 'hinge') else 5
    pos, negs, pos_items, neg_items, mask, meta = _inputs(len(name) + 10 * with_meta, K)
    if K == 1:
        negs, neg_items = negs[0], neg_items[0]
    weights = {'a': 0.25, 'b': 0.35} if with_meta else None
    common = dict(num_items=40, sample_weights=mask)
    j_fn = {'bpr': J.bpr_loss, 'hinge': J.hinge_loss, 'adaptive_bpr': J.adaptive_bpr_loss,
            'adaptive_hinge': J.adaptive_hinge_loss, 'warp': J.warp_loss}[name]

    def jax_loss(p, n):
        return j_fn(p, n, positive_items=jnp.asarray(pos_items),
                    negative_items=jnp.asarray(neg_items),
                    metadata={k: jnp.asarray(v) for k, v in meta.items()} if with_meta else None,
                    metadata_weights=weights, **{**common, 'sample_weights': jnp.asarray(mask)})

    j_val, (j_gp, j_gn) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(pos),
                                                                        jnp.asarray(negs))
    p = torch.from_numpy(pos).requires_grad_()
    n = torch.from_numpy(negs).requires_grad_()
    t_val = T.LOSSES[name](p, n, positive_items=torch.from_numpy(pos_items),
                           negative_items=torch.from_numpy(neg_items),
                           metadata={k: torch.from_numpy(v) for k, v in meta.items()}
                           if with_meta else None,
                           metadata_weights=weights, **{**common,
                                                        'sample_weights': torch.from_numpy(mask)})
    t_gp, t_gn = torch.autograd.grad(t_val, (p, n))
    np.testing.assert_allclose(float(t_val.detach()), float(j_val), rtol=1e-5)
    np.testing.assert_allclose(t_gp.numpy(), np.asarray(j_gp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(t_gn.numpy(), np.asarray(j_gn), rtol=1e-5, atol=1e-7)


def test_hardest_negative_ties_take_the_first_maximum():
    many = torch.tensor([[1.0, 2.0], [3.0, 2.0], [3.0, 0.5]])
    highest, items = T._select_hardest_negatives(many, torch.tensor([0, 1]),
                                                 torch.tensor([[10, 11], [12, 13], [14, 15]]))
    assert highest.tolist() == [3.0, 2.0]
    assert items.tolist() == [12, 11]
    j_idx = np.asarray(jnp.argmax(jnp.asarray(many.numpy()), axis=0))
    assert j_idx.tolist() == [1, 0]


@pytest.mark.parametrize('name', ['mse', 'mae'])
def test_explicit_losses_match_jax(name):
    rng = np.random.default_rng(1)
    preds, ratings = rng.standard_normal(20).astype(np.float32), rng.random(20).astype(np.float32)
    mask = (rng.random(20) > 0.3).astype(np.float32)
    j = getattr(J, f'{name}_loss')(jnp.asarray(preds), jnp.asarray(ratings), jnp.asarray(mask))
    t = T.LOSSES[name](torch.from_numpy(preds), torch.from_numpy(ratings), torch.from_numpy(mask))
    np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
