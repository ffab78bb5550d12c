"""The port's zoo training step against collie_tpu's.

Models and params as in ``tests/test_torch_zoo.py``.  One batch's loss and
the gradient of every param equal ``jax.grad`` of JAX's ``calculate_loss``
on its dense branch, K = 4 with the adaptive hinge and adaptive BPR losses
and K = 1 with the hinge loss, on JAX's dropout masks (recorded and
replayed as there): rtol 1e-4 / atol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dropout import MaskTape
from tests.test_torch_zoo import DATA, MAIN, _generator, _ids, build_pair, data  # noqa: F401

GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _batch(rng, K, B=16):
    users, pos, _ = _ids(rng, B)
    negs = rng.integers(0, DATA['num_items'], (B, K))
    mask = np.ones(B, np.float32)
    mask[-3:] = 0.0
    return {'users': users.astype(np.int32), 'pos_items': pos.astype(np.int32),
            'neg_items': negs.astype(np.int32), 'mask': mask}


@pytest.mark.parametrize('K,loss', [(4, 'adaptive'), (4, 'bpr'), (1, 'hinge')])
@pytest.mark.parametrize('variant', MAIN)
def test_loss_and_grads_match_jax(variant, K, loss, data, monkeypatch):
    """JAX's dense branch (``COLLIE_TPU_SPARSE_ADAPTIVE=0``; with dropout JAX
    takes it anyway), on JAX's masks."""
    monkeypatch.setenv('COLLIE_TPU_SPARSE_ADAPTIVE', '0')
    jax_model, model = build_pair(variant, data, K=K, loss=loss)
    tape = MaskTape(monkeypatch)
    batch = _batch(np.random.default_rng(2), K)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(
        lambda p, b, key: jax_model.calculate_loss(p, b, rng=key, training=True)))(
            jax_model.params, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(9))
    leaves = {k: v.clone().requires_grad_() for k, v in model.params.items()}
    loss_value = model.calculate_loss(leaves, {k: torch.from_numpy(v) for k, v in batch.items()},
                                      generator=_generator(), training=True)
    grads = torch.autograd.grad(loss_value, list(leaves.values()), allow_unused=True)
    assert not tape.masks
    np.testing.assert_allclose(float(loss_value.detach()), float(ref_loss), **GRAD_TOL)
    for (name, value), grad in zip(leaves.items(), grads):
        grad = torch.zeros_like(value) if grad is None else grad
        np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grads[name]), **GRAD_TOL,
                                   err_msg=f'grad of {name}')
