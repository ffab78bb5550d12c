"""Embedding dropout in the port (``collie_tpu_torch/ops/embeddings.py``)
against ``collie_tpu/ops/embeddings.py``.

Torch's and JAX's random streams never match, so parity runs on injected
masks: the masks JAX draws (``jax.random.bernoulli``, wrapped to record
each mask in program order, eagerly or under ``jit``) are handed in that
order to the port's one mask function, ``dropout_mask``.  Outputs and gradients must then agree within rtol 1e-5 /
atol 1e-6.  The port's own draws are held to their statistics: the kept
fraction within 3 standard deviations of ``1 - rate``, survivors scaled by
exactly ``1 / (1 - rate)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops import embeddings as jax_embeddings
from collie_tpu_torch import MatrixFactorizationModel
from collie_tpu_torch.data import Interactions
from collie_tpu_torch.models.base import BasePipeline
from collie_tpu_torch.ops import embeddings
from collie_tpu_torch.training import scan_engine

RTOL, ATOL = 1e-5, 1e-6


class MaskTape:
    """Records the masks JAX draws, in the order its program draws them, and
    replays them in that order as the port's ``dropout_mask``.

    Each ``jax.random.bernoulli`` call becomes a host callback that draws
    the mask with the original ``bernoulli`` on the call's concrete key, so
    JAX programs can run under ``jit`` (without compiling the draws) and
    still use exactly their own masks; a slot reserved when the call is
    traced keeps the program order."""

    def __init__(self, monkeypatch):
        self.masks = []
        bernoulli = jax.random.bernoulli

        def record(key, p, shape):
            slot = [None, float(p)]
            self.masks.append(slot)

            def draw(concrete_key):
                slot[0] = np.array(bernoulli(concrete_key, p, shape))
                return slot[0]

            return jax.pure_callback(draw, jax.ShapeDtypeStruct(tuple(shape), jnp.bool_), key)

        monkeypatch.setattr(jax.random, 'bernoulli', record)
        monkeypatch.setattr(embeddings, 'dropout_mask', self.replay)

    def replay(self, generator, shape, keep):
        mask, p = self.masks.pop(0)
        assert tuple(mask.shape) == tuple(shape), (mask.shape, shape)
        assert np.isclose(p, keep)
        return torch.from_numpy(mask).to(generator.device)


def _generator(seed=0):
    generator = torch.Generator()
    generator.manual_seed(seed)
    return generator


@pytest.mark.parametrize('rate', [0.05, 0.3, 0.7])
def test_dropout_statistics(rate):
    x = torch.full((400, 250), 2.0)
    out = embeddings.dropout(_generator(1), x, rate, training=True)
    kept = out != 0
    n = x.numel()
    keep = 1.0 - rate
    sigma = np.sqrt(n * keep * rate)
    assert abs(int(kept.sum()) - n * keep) < 3 * sigma
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 2.0 / keep),
                               rtol=0, atol=0)


def test_dropout_is_the_identity_outside_training():
    x = torch.randn(5, 4)
    for args in ((_generator(), x, 0.5, False), (_generator(), x, 0.0, True),
                 (None, x, 0.5, True)):
        assert embeddings.dropout(*args) is x


def test_dropout_masks_come_from_the_generator():
    x = torch.ones(64, 16)
    a = embeddings.dropout(_generator(7), x, 0.5, True)
    b = embeddings.dropout(_generator(7), x, 0.5, True)
    c = embeddings.dropout(_generator(8), x, 0.5, True)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_dropout_matches_jax_on_injected_masks(monkeypatch):
    tape = MaskTape(monkeypatch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    g = rng.standard_normal((6, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    ref_out, ref_grad = jax.vjp(lambda v: jax_embeddings.dropout(key, v, 0.3, True),
                                jnp.asarray(x))
    ref_grad = ref_grad(jnp.asarray(g))[0]
    assert len(tape.masks) == 1
    xt = torch.from_numpy(x).requires_grad_()
    out = embeddings.dropout(_generator(), xt, 0.3, True)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    assert not tape.masks
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('training,rate', [(True, 0.25), (False, 0.25), (True, 0.0)])
def test_tiled_dropout_dots_match_jax(monkeypatch, training, rate):
    tape = MaskTape(monkeypatch)
    rng = np.random.default_rng(1)
    R, B, d = 3, 7, 5
    users = rng.standard_normal((B, d)).astype(np.float32)
    items = rng.standard_normal((R, B, d)).astype(np.float32)
    rng_u, rng_i = jax.random.split(jax.random.PRNGKey(0))
    ref = jax_embeddings.tiled_dropout_dots(jnp.asarray(users), jnp.asarray(items), R, B,
                                            rate, training, rng_u, rng_i)
    out = embeddings.tiled_dropout_dots(torch.from_numpy(users), torch.from_numpy(items),
                                        R, B, rate, training, _generator())
    assert not tape.masks
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_tiled_masks_equal_the_base_hooks_tiled_masks():
    """MF's ``pairwise_scores`` draws its masks at ``[R, B, d]``; the base
    hook tiles the users and draws at ``[R*B, d]``.  From one seed the two
    give the same scores: the masks are equal element for element."""
    inter = Interactions(users=np.arange(20) % 10, items=np.arange(20) % 15,
                         num_users=10, num_items=15, num_negative_samples=2,
                         allow_missing_ids=True)
    model = MatrixFactorizationModel(train=inter, embedding_dim=6, dropout_p=0.4, seed=0,
                                     map_location='cpu')
    users = torch.arange(10)
    items = torch.randint(0, 15, (4, 10), generator=_generator(2))
    fast = model.pairwise_scores(model.params, users, items, training=True,
                                 generator=_generator(5))
    tiled = BasePipeline.pairwise_scores(model, model.params, users, items, training=True,
                                         generator=_generator(5))
    assert torch.equal(fast, tiled)
    other = model.pairwise_scores(model.params, users, items, training=True,
                                  generator=_generator(6))
    assert not torch.equal(fast, other)


def test_split_generator():
    a1, a2 = embeddings.split_generator(_generator(4))
    b1, b2 = embeddings.split_generator(_generator(4))
    draw = lambda g: torch.rand(8, generator=g)  # noqa: E731
    assert torch.equal(draw(a1), draw(b1)) and torch.equal(draw(a2), draw(b2))
    c1, c2 = embeddings.split_generator(_generator(4))
    assert not torch.equal(draw(c1), draw(c2))
    assert embeddings.split_generator(None) == (None, None)


def test_dropout_step_seeds():
    seeds = scan_engine.dropout_step_seeds(0, 1, 5)
    assert seeds == scan_engine.dropout_step_seeds(0, 1, 5)
    assert len(set(seeds)) == 5
    assert set(seeds).isdisjoint(scan_engine.dropout_step_seeds(0, 2, 5))
    assert set(seeds).isdisjoint(scan_engine.dropout_step_seeds(1, 1, 5))
    assert all(0 <= s < 2 ** 64 for s in seeds)
