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
from collie_tpu_torch.ops.kernels.retrieval_kernel import (INT32_MAX, MAX_K, NEG_INF,
                                                           TILE_ITEMS, USER_CHUNKS,
                                                           _merge_tiles, mf_topk_retrieve,
                                                           mf_topk_retrieve_plain, select_plan,
                                                           stable_topk, stable_topk_plain,
                                                           topk_plan, topk_select_cuda,
                                                           topk_shared_bytes,
                                                           topk_tiles_plain)

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


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize('k', [1, 10, MAX_K + 1])
def test_cpu_scores_take_the_stable_sort_without_a_selection(dtype, k):
    """On the CPU ``stable_topk`` is the full stable sort, whatever the dtype
    or k, equal values in ascending index order, and the selection kernel's
    count does not move."""
    before = stable_topk.launches
    rng = np.random.default_rng(2)
    scores = torch.from_numpy(rng.integers(0, 3, (6, 300)).astype(np.float32)).to(dtype)
    for block in (scores, scores[0], scores.T):
        values, idx = stable_topk(block, k)
        ref_values, ref_idx = stable_topk_plain(block, k)
        assert torch.equal(values, ref_values) and torch.equal(idx, ref_idx)
        assert values.dtype == dtype and idx.dtype == torch.int64
        rows = block.float().numpy().reshape(-1, block.shape[-1])
        order = [np.lexsort((np.arange(len(row)), -row))[:k].tolist() for row in rows]
        assert idx.reshape(len(rows), -1).tolist() == order
    assert stable_topk.launches == before


@pytest.mark.parametrize('call', [topk_select_cuda, select_plan])
@pytest.mark.parametrize('scores,k,error', [
    (torch.zeros(4, 10, dtype=torch.float64), 3, TypeError),
    (torch.zeros(4, 10, dtype=torch.int32), 3, TypeError),
    (torch.zeros(4, 10, dtype=torch.bool), 3, TypeError),
    (torch.zeros(()), 1, ValueError),
    (torch.zeros(4, 10), -1, ValueError),
    (torch.empty(1, INT32_MAX + 1, device='meta'), 10, ValueError),
    (torch.zeros(4, 10), 3, ValueError),                 # not on the card
    (torch.zeros(4, 10, dtype=torch.float16), 3, ValueError),
    (torch.zeros(4, 10, dtype=torch.bfloat16), 3, ValueError),
])
def test_selection_wrapper_rejects_what_the_kernel_does_not_take(call, scores, k, error):
    before = stable_topk.launches
    with pytest.raises(error):
        call(scores, k)
    assert stable_topk.launches == before


def test_stable_topk_runs_on_cuda_or_cpu_only():
    with pytest.raises(ValueError, match='cuda or cpu'):
        stable_topk(torch.empty(4, 10, device='meta'), 3)


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


PLAN_SHAPES = [(1, 1, 1, 1), (37, 12, 10, 611), (256, 64, 10, 2_000_000),
               (256, 64, 128, 2_000_000), (300, 65, 128, 128), (5, 256, 100, 100),
               (4096, 64, 10, 2_000_000), (129, 3, 1, 129)]


@pytest.mark.parametrize('B,D,k,num_items', PLAN_SHAPES)
def test_topk_plan_covers_every_item_once_in_order(B, D, k, num_items):
    """The plan's ranges cover the catalog once, in increasing order, each a
    whole number of tiles; its user chunks cover B; its grid fills the SMs
    it was planned for (or has a range per tile)."""
    plan = topk_plan(B, D, k, num_items, sms=132)
    starts = [r * plan.range_width for r in range(plan.n_ranges)]
    stops = [min(s + plan.range_width, num_items) for s in starts]
    assert starts[0] == 0 and stops[-1] == num_items
    assert all(a < b for a, b in zip(starts, stops))
    assert all(stop == start for stop, start in zip(stops, starts[1:]))
    assert plan.range_width % TILE_ITEMS == 0
    assert plan.n_chunks * plan.user_chunk >= B > (plan.n_chunks - 1) * plan.user_chunk
    n_tiles = -(-num_items // TILE_ITEMS)
    assert plan.n_chunks * plan.n_ranges <= 132 * plan.blocks_per_sm or plan.n_ranges == 1
    assert plan.n_ranges == n_tiles or plan.n_chunks * plan.n_ranges > 66 * plan.blocks_per_sm
    assert plan.threads == 2 * plan.user_chunk


def test_topk_plan_fits_shared_memory_for_every_dim_and_k():
    """Every D <= 256 and k <= 128 gets a plan within the 227 KB a block may
    use, the plan's bytes are what its chunk and lists need, and the lists
    leave shared memory only where they do not fit there."""
    for D in range(1, 257):
        for k in range(1, MAX_K + 1):
            plan = topk_plan(256, D, k, 2_000_000)
            assert plan.shared_bytes <= 232_448
            assert plan.shared_bytes == topk_shared_bytes(plan.user_chunk, D, k,
                                                          plan.lists_in_shared)
            assert plan.user_chunk in USER_CHUNKS
            if not plan.lists_in_shared:
                assert topk_shared_bytes(plan.user_chunk, D, k, True) > 232_448
    with pytest.raises(ValueError, match='shared memory'):
        topk_plan(256, 4096, 128, 2_000_000)


@pytest.mark.parametrize('m', [2, 3])
@pytest.mark.parametrize('B,tile,k', EDGE_ENVELOPES)
def test_wider_ranges_merge_to_the_per_tile_result(B, tile, k, m):
    """Candidates of ranges m tiles wide, merged, equal today's per-tile
    result and the Pallas kernel in interpret mode: the merge of any
    partition of the catalog is the stable top-k."""
    arrays = _inputs(B * 1000 + tile + k, B)
    ue, ub, ie, ib = map(torch.from_numpy, arrays)
    per_tile = _merge_tiles(*topk_tiles_plain(ue, ie, ib, k, tile), ub, k)
    wide_scores, wide_ids = topk_tiles_plain(ue, ie, ib, k, m * tile)
    assert wide_scores.shape == (-(-611 // (m * tile)), B, k)
    wide = _merge_tiles(wide_scores, wide_ids, ub, k)
    assert torch.equal(wide[0], per_tile[0]) and torch.equal(wide[1], per_tile[1])
    jax_ids, jax_scores = jax_mf_topk_retrieve(*map(jnp.asarray, arrays), k=k, tile=tile,
                                               interpret=True)
    np.testing.assert_array_equal(wide[0].numpy(), np.asarray(jax_ids))
    np.testing.assert_allclose(wide[1].numpy(), np.asarray(jax_scores), rtol=1e-5, atol=1e-5)


def test_range_with_fewer_than_k_items_pads_with_its_first_id():
    """The last range holds 3 items with k = 5: its two padding entries are
    (finfo.min, the range's first id), the kernel's padding."""
    ue, _, ie, ib = map(torch.from_numpy, _inputs(4, 3, num_items=11, dim=4))
    scores, ids = topk_tiles_plain(ue, ie, ib, k=5, tile=8)
    assert (scores[1, :, 3:] == NEG_INF).all() and (ids[1, :, 3:] == 8).all()
    assert torch.isfinite(scores[1, :, :3]).all()
    assert sorted(ids[1, 0, :3].tolist()) == [8, 9, 10]
