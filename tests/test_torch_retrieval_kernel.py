"""The port's retrieval kernel module against the Pallas kernel.

On the CPU ``mf_topk_retrieve`` runs its plain PyTorch version; it is held
to ``collie_tpu``'s ``mf_topk_retrieve(..., interpret=True)`` as
``tests/test_retrieval.py`` runs it: ids equal, scores within 1e-5.  The
CUDA kernel itself is held to the plain version on the card by
``tests/test_torch_kernels_cuda.py`` and by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from collie_tpu.ops.pallas.retrieval_kernel import mf_topk_retrieve as jax_mf_topk_retrieve
from collie_tpu_torch.ops.kernels.retrieval_kernel import (NEG_INF, mf_topk_retrieve,
                                                           mf_topk_retrieve_plain,
                                                           stable_topk, topk_tiles_plain)

EDGE_ENVELOPES = [
    (37, 257, 10),    # B > 8, unaligned; tile does not divide the catalog
    (1, 64, 5),       # single user
    (9, 4096, 10),    # tile larger than the catalog
    (16, 128, 128),   # k at the kernel's limit
]


def _inputs(seed, B, num_items=611, dim=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, dim)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32),
            rng.standard_normal((num_items, dim)).astype(np.float32),
            rng.standard_normal(num_items).astype(np.float32))


def _both(arrays, k, tile):
    jax_ids, jax_scores = jax_mf_topk_retrieve(*map(jnp.asarray, arrays), k=k, tile=tile,
                                               interpret=True)
    ids, scores = mf_topk_retrieve(*map(torch.from_numpy, arrays), k=k, tile=tile)
    return (np.asarray(jax_ids), np.asarray(jax_scores)), (ids.numpy(), scores.numpy())


@pytest.mark.parametrize('B,tile,k', EDGE_ENVELOPES)
def test_plain_matches_pallas_kernel_edge_envelopes(B, tile, k):
    (jax_ids, jax_scores), (ids, scores) = _both(_inputs(B * 1000 + tile + k, B), k, tile)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_allclose(scores, jax_scores, rtol=1e-5, atol=1e-5)
    assert ids.dtype == np.int32 and scores.dtype == np.float32


def test_tile_narrower_than_k_matches_pallas_kernel():
    """Tiles of 4 items with k=10: every tile pads its candidates, and the
    merge must still return the JAX ids."""
    (jax_ids, jax_scores), (ids, scores) = _both(_inputs(5, 6, num_items=50), 10, 4)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_allclose(scores, jax_scores, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('tile', [7, 64, 1000])
def test_ties_go_to_lowest_item_id(tile):
    """Duplicated item rows and biases on a coarse grid tie exactly (every
    sum is exact in float32); ids must follow lax.top_k's lowest-id rule
    inside tiles and across them."""
    rng = np.random.default_rng(tile)
    grid = lambda shape: (rng.integers(-2, 3, shape) / 4).astype(np.float32)  # noqa: E731
    ue, ub, ie, ib = grid((5, 6)), grid(5), grid((300, 6)), grid(300)
    ie[150:], ib[150:] = ie[:150], ib[:150]
    (jax_ids, jax_scores), (ids, scores) = _both((ue, ub, ie, ib), 40, tile)
    np.testing.assert_array_equal(ids, jax_ids)
    np.testing.assert_array_equal(scores, jax_scores)
    full = ue @ ie.T + ub[:, None] + ib[None, :]
    expected = np.stack([np.lexsort((np.arange(300), -row))[:40] for row in full])
    np.testing.assert_array_equal(ids, expected)


def test_stable_topk_keeps_index_order_on_ties():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    values, idx = stable_topk(scores, 3)
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]
    assert values.tolist() == [[3.0, 3.0, 3.0], [0.0, 0.0, 0.0]]


def test_tile_candidates_mask_the_catalog_tail():
    """Per-tile candidates: the last tile's padding columns score finfo.min
    (the JAX sentinel, not -inf) and a tile narrower than k pads with its base id."""
    ue, _, ie, ib = map(torch.from_numpy, _inputs(3, 2, num_items=10, dim=4))
    scores, ids = topk_tiles_plain(ue, ie, ib, k=6, tile=8)
    assert scores.shape == ids.shape == (2, 2, 6)
    assert (scores[1, :, 2:] == NEG_INF).all()      # last tile holds 2 real items
    assert (ids[1, :, :2] >= 8).all() and (ids[1, :, :2] < 10).all()
    assert torch.isfinite(scores).all()


def test_cpu_tensors_take_the_plain_version_without_launching():
    arrays = [torch.from_numpy(a) for a in _inputs(1, 4)]
    before = mf_topk_retrieve.launches
    ids, scores = mf_topk_retrieve(*arrays, k=10, tile=128)
    plain_ids, plain_scores = mf_topk_retrieve_plain(*arrays, k=10, tile=128)
    assert mf_topk_retrieve.launches == before
    assert torch.equal(ids, plain_ids) and torch.equal(scores, plain_scores)


@pytest.mark.parametrize('change,error', [
    (dict(k=129), ValueError),
    (dict(k=0), ValueError),
    (dict(k=700), ValueError),
    (dict(tile=0), ValueError),
    (dict(dtype=torch.float64), TypeError),
    (dict(item_dim=5), ValueError),
    (dict(device='meta'), ValueError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(change, error):
    ue, ub, ie, ib = [torch.from_numpy(a) for a in _inputs(2, 3)]
    if 'dtype' in change:
        ue = ue.to(change['dtype'])
    if 'item_dim' in change:
        ie = ie[:, :change['item_dim']]
    if 'device' in change:
        ue, ub, ie, ib = [t.to(change['device']) for t in (ue, ub, ie, ib)]
    with pytest.raises(error):
        mf_topk_retrieve(ue, ub, ie, ib, k=change.get('k', 10), tile=change.get('tile', 64))
