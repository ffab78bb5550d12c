"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The fused epochs' edge shapes, inputs and tolerance are
``chip_smoke.py``'s, and so are the top-k kernel's edge shapes and checks,
the binned gather/scatter's inputs, shapes and tolerance, the selection's
shapes and bit-for-bit check against the stable sort, the cycle-walk's
key sets and bit-for-bit check, the skipped-launch check and the guard that
turns a host sync inside a whole fit's flight into an error; the bucketed
sampler's tables built on the card against their CPU build, and its
kernel (``csrc/bucketed_sample.cu``) against its plain version at
``SAMPLE_CASES`` and through whole fits.  The file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import (EPOCH_EDGES, EXPLICIT_EDGES, EXPLICIT_STATE, GS_ATOL_SCALE,
                        GS_OVERSIZE, GS_SHAPE, IMPLICIT_STATE, SELECT_KS,
                        SELECT_LARGE, SELECT_LENGTHS, SELECT_ROWS, SELECT_SHAPE,
                        SHUFFLE_KEY_SETS, TOPK_EDGES, check_cycle_walk, check_repeatable,
                        check_skipped_launch, compare_epoch, compare_select,
                        compare_topk_kernel, epoch_inputs, explicit_epoch_inputs,
                        gather_scatter_inputs, sampler_problem, sampler_uniforms, special_rows,
                        sync_errors)
from collie_tpu_torch.ops.kernels.retrieval_kernel import (mf_topk_retrieve,
                                                           mf_topk_retrieve_plain, select_plan,
                                                           stable_topk, stable_topk_plain)

EDGE_ENVELOPES = [(37, 257, 10), (1, 64, 5), (9, 4096, 10), (16, 128, 128)]
# (K, dedup_rounds, chunk) of the bucketed sampler kernel's cases: each of
# its register kernel's compile-time widths (up to 8, 16, 32 and 64
# uniforms a slot), the widest rows there with one and two dedup rounds, no
# dedup, chunk-pad slots (chunk 256) and none (chunk 1: N_g odd), and rows
# past 64 uniforms (65, 100 and 132), which take its wide kernel
SAMPLE_CASES = [(1, 1, 256), (4, 1, 256), (10, 1, 256), (10, 2, 1), (10, 0, 256), (20, 1, 1),
                (62, 1, 256), (60, 2, 1), (63, 1, 1), (100, 0, 1), (128, 2, 256)]


def _inputs(seed, B, num_items=611, dim=12):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, dim)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32),
            rng.standard_normal((num_items, dim)).astype(np.float32),
            rng.standard_normal(num_items).astype(np.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernel has no CPU mode')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('B,tile,k', EDGE_ENVELOPES)
def test_cuda_kernel_matches_plain_version(cuda_device, B, tile, k):
    arrays = [torch.from_numpy(a).to(cuda_device) for a in _inputs(B * 1000 + tile + k, B)]
    before = mf_topk_retrieve.launches
    ids, scores = mf_topk_retrieve(*arrays, k=k, tile=tile)
    plain_ids, plain_scores = mf_topk_retrieve_plain(*arrays, k=k, tile=tile)
    torch.cuda.synchronize()
    assert mf_topk_retrieve.launches == before + 1
    assert torch.equal(ids, plain_ids)
    torch.testing.assert_close(scores, plain_scores, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize('loss_kind,adaptive,K,B,D,F,wd,dup', EPOCH_EDGES)
def test_fused_epoch_kernel_matches_plain_version(cuda_device, loss_kind, adaptive, K, B, D,
                                                  F, wd, dup):
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_epoch_plain)

    args, meta = epoch_inputs(K * 100 + B + D, D=D, B=B, K=K, F=F, dup=dup)
    kw = dict(K=K, adaptive=adaptive, loss_kind=loss_kind,
              meta_weights=(0.3, 0.2)[:F] if F != 1 else (0.5,), wd_emb=wd, wd_bias=wd)
    ref = fused_mf_epoch_plain(*args, meta, **kw)
    before = fused_mf_epoch.launches
    out = fused_mf_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], meta, **kw)
    torch.cuda.synchronize()
    assert fused_mf_epoch.launches == before + 1
    compare_epoch(f'{loss_kind} adaptive={adaptive} K={K}', out, ref)


@pytest.mark.cuda
def test_fit_on_the_card_goes_through_the_kernel(cuda_device):
    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel, stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch

    train, _ = stratified_split(generate_implicit_interactions(
        num_users=250, num_items=500, num_interactions=20_000, seed=1), test_p=0.2, seed=1,
        force_split=True)
    model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-1, loss='adaptive',
                                     seed=0)
    before = fused_mf_epoch.launches
    trainer = CollieTrainer(model, max_epochs=3, verbosity=0)
    trainer.fit(model)
    torch.cuda.synchronize()
    assert fused_mf_epoch.launches == before + 3
    assert model.device.type == 'cuda'
    assert all(torch.isfinite(v).all() for v in model.params.values())


@pytest.mark.cuda
def test_card_fit_matches_the_cpu_fit(cuda_device, monkeypatch):
    """The same fit on the card (the kernel) and on the CPU (the generic
    autograd epoch), with the same epoch draws made from a numpy seed:
    params agree within 5e-4 * max|param| after 2 epochs, the tolerance of
    tests/test_fused_epoch.py:92-95 (gradient sums in another order, which
    Adam amplifies), per-epoch losses within rtol 1e-4.  The kernel selects
    the hardest negative on float32 scores, so the generic epoch selects in
    float32 too (its default bfloat16 selection picks other negatives where
    two scores lie within its rounding)."""
    from collie_tpu_torch import (CollieTrainer, MatrixFactorizationModel, stratified_split)
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions
    from collie_tpu_torch.training import scan_engine

    def numpy_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items, exact):
        rng = np.random.default_rng((seed, epoch_idx, int(training)))
        keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, 4)).to(device) if perm_n else None
        u01 = torch.from_numpy(rng.random(sample_shape, dtype=np.float32)).to(device)
        return keys, u01

    monkeypatch.setattr(scan_engine, 'draw_epoch', numpy_draws)
    monkeypatch.setenv('COLLIE_TPU_BF16_SELECT', '0')
    train, _ = stratified_split(generate_implicit_interactions(
        num_users=250, num_items=500, num_interactions=20_000, seed=1), test_p=0.2, seed=1,
        force_split=True)
    results = []
    for device in ('cuda', 'cpu'):
        model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-1, loss='adaptive',
                                         seed=0, map_location=device)
        if results:
            model.load_params({k: v.to(device) for k, v in results[0][2].items()})
        start = {k: v.detach().cpu().clone() for k, v in model.params.items()}
        losses = []

        class Recorder:
            def log_metrics(self, metrics, step):
                losses.append(metrics['train_loss_epoch'])

        CollieTrainer(model, max_epochs=2, verbosity=0, logger=Recorder()).fit(model)
        results.append(({k: v.cpu() for k, v in model.params.items()}, losses, start))
    (card, card_losses, _), (cpu, cpu_losses, _) = results
    np.testing.assert_allclose(card_losses, cpu_losses, rtol=1e-4)
    for k, ref in cpu.items():
        scale = max(float(ref.abs().max()), 1e-3)
        torch.testing.assert_close(card[k], ref, rtol=0, atol=5e-4 * scale, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize('loss_kind,y_range,B,D,wd,dup,tail',
                         [EXPLICIT_EDGES[2], EXPLICIT_EDGES[5]])
def test_explicit_epoch_kernel_matches_plain_version(cuda_device, loss_kind, y_range, B, D, wd,
                                                     dup, tail):
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_explicit_epoch,
                                                             fused_mf_explicit_epoch_plain)

    args = explicit_epoch_inputs(B * 10 + D, D=D, B=B, dup=dup, tail=tail)
    kw = dict(loss_kind=loss_kind, y_range=y_range, wd_emb=wd, wd_bias=wd)
    ref = fused_mf_explicit_epoch_plain(*args, **kw)
    before = fused_mf_explicit_epoch.launches
    out = fused_mf_explicit_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], **kw)
    torch.cuda.synchronize()
    assert fused_mf_explicit_epoch.launches == before + 1
    compare_epoch(f'{loss_kind} y_range={y_range}', out, ref, names=EXPLICIT_STATE)


def _explicit_train():
    from collie_tpu_torch import ExplicitInteractions, stratified_split
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(num_users=250, num_items=500, num_interactions=20_000, seed=1)
    inter = ExplicitInteractions(users=df['user_id'].values, items=df['item_id'].values,
                                 ratings=df['rating'].values, allow_missing_ids=True,
                                 num_users=250, num_items=500)
    return stratified_split(inter, test_p=0.2, seed=1, force_split=True)


@pytest.mark.cuda
def test_explicit_fit_on_the_card_goes_through_the_kernel(cuda_device):
    """An explicit MF fit launches the explicit kernel once per epoch; the
    engine's ``fused=False`` epoch launches none."""
    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_explicit_epoch
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    train, _ = _explicit_train()
    model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-2, loss='mse',
                                     y_range=(1, 5), seed=0)
    before = fused_mf_explicit_epoch.launches
    CollieTrainer(model, max_epochs=3, verbosity=0).fit(model)
    torch.cuda.synchronize()
    assert fused_mf_explicit_epoch.launches == before + 3
    assert all(torch.isfinite(v).all() for v in model.params.values())
    assert float(model.params['user_biases'].abs().max()) > 1e-4
    specs = model.optimizer_specs()
    fn, data, _, _ = build_scan_epoch_fns(model, specs, [True, True], model.train_loader,
                                          shuffle=True, fused=False)
    states = tuple(s.transform.init({k: model.params[k] for k in s.keys}) for s in specs)
    fn(model.params, states, data, 0, 1)
    torch.cuda.synchronize()
    assert fn.fused is False and fused_mf_explicit_epoch.launches == before + 3


# (S, B, D) of the persistent epoch kernels: no step, one step, B far below
# the cooperative grid and not a multiple of 8, every row layout (D = 1 and
# 10: strided floats in 16 lanes; 33: strided in 32; 256: float4 chunks)
PERSISTENT_SHAPES = [(0, 7, 10), (1, 7, 10), (2, 13, 1), (3, 13, 33), (2, 5, 256),
                     (3, 300, 10), (2, 300, 32)]
LOSSES = [('hinge', True), ('warp', False), ('bpr', False)]


@pytest.mark.cuda
@pytest.mark.parametrize('S,B,D', PERSISTENT_SHAPES)
def test_persistent_epoch_kernel_matches_plain_version(cuda_device, S, B, D):
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_epoch_plain)

    loss_kind, adaptive = LOSSES[(S + B + D) % len(LOSSES)]
    args, _ = epoch_inputs(S * 1000 + B + D, D=D, S=S, B=B, K=4)
    kw = dict(K=4, adaptive=adaptive, loss_kind=loss_kind)
    ref = fused_mf_epoch_plain(*args, **kw)
    before = fused_mf_epoch.launches
    out = fused_mf_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], **kw)
    torch.cuda.synchronize()
    assert fused_mf_epoch.launches == before + 1
    assert out[8].shape == (S,)
    compare_epoch(f'S={S} B={B} D={D} {loss_kind}', out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize('S,B,D', PERSISTENT_SHAPES)
def test_persistent_explicit_epoch_kernel_matches_plain_version(cuda_device, S, B, D):
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_explicit_epoch,
                                                             fused_mf_explicit_epoch_plain)

    args = explicit_epoch_inputs(S * 1000 + B + D, D=D, S=S, B=B)
    kw = dict(loss_kind='mse' if D % 2 else 'mae', y_range=(1, 5) if B % 2 else None)
    ref = fused_mf_explicit_epoch_plain(*args, **kw)
    before = fused_mf_explicit_epoch.launches
    out = fused_mf_explicit_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], **kw)
    torch.cuda.synchronize()
    assert fused_mf_explicit_epoch.launches == before + 1
    compare_epoch(f'S={S} B={B} D={D}', out, ref, names=EXPLICIT_STATE)


@pytest.mark.cuda
@pytest.mark.parametrize('explicit', [False, True])
@pytest.mark.parametrize('D', [10, 32])
def test_two_launches_from_one_state_are_bit_identical(cuda_device, explicit, D):
    """The epoch kernels sum gradients in fixed point: two launches from one
    state, half of each step's examples on one user and one item, give
    the same bits (``chip_smoke.check_repeatable``)."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_explicit_epoch)

    if explicit:
        args = explicit_epoch_inputs(D, D=D, S=4, B=300, dup=True)
        check_repeatable(f'explicit D={D}', lambda: fused_mf_explicit_epoch(
            *[a.clone() if torch.is_tensor(a) else a for a in args], loss_kind='mse'),
            EXPLICIT_STATE)
    else:
        args, _ = epoch_inputs(D, D=D, S=4, B=300, K=5, dup=True)
        check_repeatable(f'implicit D={D}', lambda: fused_mf_epoch(
            *[a.clone() if torch.is_tensor(a) else a for a in args], K=5, adaptive=True,
            loss_kind='hinge'), IMPLICIT_STATE)


@pytest.mark.cuda
def test_an_add_out_of_fixed_point_range_reaches_the_host_as_nan(cuda_device):
    """A gradient element beyond the accumulators' range is not wrapped:
    the launch's losses from that step on, and the tables it updates, are
    NaN, which the NaN trip reads at the next sync."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch

    args, _ = epoch_inputs(5, D=10, S=3, B=7, K=2)
    args[0][:] = 1e30                      # user rows: every item gradient overflows
    out = fused_mf_epoch(*args, K=2, adaptive=False, loss_kind='hinge')
    losses = out[8].cpu()
    assert torch.isnan(losses).all()
    assert torch.isnan(out[1]).all() and torch.isnan(out[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize('D,iters', [(8, 3), (33, 2), (32, 0)])
def test_gather_scatter_kernel_matches_plain_version(cuda_device, D, iters):
    from collie_tpu_torch.ops.kernels.gather_scatter import (binned_gather_scatter,
                                                             binned_gather_scatter_plain,
                                                             kept_examples)

    (tab_t, sids, offs, g_t), _ = gather_scatter_inputs(D, U=3000, D=D, B=700, n_bins=4)
    c_pad = 128                 # bins of ~175 examples: each drops some past its window
    before = binned_gather_scatter.launches
    out, gathered = binned_gather_scatter(tab_t, sids, offs, g_t, iters, c_pad)
    ref_out, ref_gathered = binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters, c_pad)
    torch.cuda.synchronize()
    assert binned_gather_scatter.launches == before + 1
    n_kept = int(kept_examples(sids, offs, tab_t.shape[1], c_pad).sum())
    assert 0 < n_kept < sids.shape[0]
    top = float(ref_out.abs().max())
    torch.testing.assert_close(out, ref_out, rtol=0, atol=GS_ATOL_SCALE * top)
    torch.testing.assert_close(gathered, ref_gathered, rtol=0,
                               atol=GS_ATOL_SCALE * n_kept * top)


@pytest.mark.cuda
@pytest.mark.parametrize('explicit', [False, True])
def test_timeline_stamps_every_phase_of_the_launch(cuda_device, explicit):
    """With a timeline the launch stamps its start and the end of each step
    and update phase, in order, and computes what it computes without one."""
    from collie_tpu_torch.ops.kernels import fused_mf_epoch as fused

    S = 3
    timeline = torch.zeros(2 * S + 1, dtype=torch.int64, device=cuda_device)
    if explicit:
        args, kw, names = explicit_epoch_inputs(11, S=S, B=100), dict(loss_kind='mse'), \
            EXPLICIT_STATE
        plain, cuda = fused.fused_mf_explicit_epoch_plain, fused.fused_mf_explicit_epoch_cuda
    else:
        args, kw = epoch_inputs(11, S=S, B=100, K=4)[0], dict(K=4, adaptive=True,
                                                              loss_kind='hinge')
        names = IMPLICIT_STATE
        plain, cuda = fused.fused_mf_epoch_plain, fused.fused_mf_epoch_cuda
    ref = plain(*args, **kw)
    out = cuda(*[a.clone() if torch.is_tensor(a) else a for a in args], timeline=timeline, **kw)
    torch.cuda.synchronize()
    stamps = timeline.cpu()
    assert stamps[0] > 0 and bool((stamps[1:] >= stamps[:-1]).all())
    compare_epoch(f'timeline explicit={explicit}', out, ref, names=names)


def _card(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize('B,D,k,num_items', TOPK_EDGES + [(256, 64, 128, 200_000)])
def test_topk_kernel_candidates_match_plain_version(cuda_device, B, D, k, num_items):
    """Per-range candidates at the plan's range width and the merged top-k,
    held as ``chip_smoke.py`` holds them (scores within 1e-5, ids as sets
    but for near-ties at the k-th place, every score its id's score)."""
    rng = np.random.default_rng(B * 7 + D * 131 + k + num_items)
    ue, ub = _card(rng, (B, D), cuda_device), _card(rng, (B,), cuda_device)
    ie, ib = _card(rng, (num_items, D), cuda_device), _card(rng, (num_items,), cuda_device)
    before = mf_topk_retrieve.launches
    compare_topk_kernel(f'B={B} D={D} k={k}', ue, ub, ie, ib, k)
    assert mf_topk_retrieve.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize('k', [40, 128])
def test_topk_kernel_ties_are_exact(cuda_device, k):
    """Duplicated rows on a coarse grid tie exactly: candidates and merged
    top-k equal the plain version's and the dense stable top-k bit for bit."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (topk_plan, topk_tiles_cuda,
                                                               topk_tiles_plain)

    rng = np.random.default_rng(k)
    grid = lambda shape: torch.tensor(  # noqa: E731
        rng.integers(-2, 3, shape).astype(np.float32) / 4, device=cuda_device)
    ue, ub, ie, ib = grid((24, 12)), grid((24,)), grid((611, 12)), grid((611,))
    ie[300:600], ib[300:600] = ie[:300].clone(), ib[:300].clone()
    ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=k)
    ref_scores, ref_ids = stable_topk_plain(ue @ ie.T + ub[:, None] + ib[None, :], k)
    plan = topk_plan(24, 12, k, 611, torch.cuda.get_device_properties(0).multi_processor_count)
    cand = topk_tiles_cuda(ue, ie, ib, k)
    ref_cand = topk_tiles_plain(ue, ie, ib, k, plan.range_width)
    torch.cuda.synchronize()
    assert torch.equal(ids.long(), ref_ids) and torch.equal(scores, ref_scores)
    assert all(torch.equal(a, b) for a, b in zip(cand, ref_cand))


@pytest.mark.cuda
@pytest.mark.parametrize('rows', SELECT_ROWS)
@pytest.mark.parametrize('length', SELECT_LENGTHS)
@pytest.mark.parametrize('k', SELECT_KS)
def test_selection_matches_the_stable_sort(cuda_device, rows, length, k):
    """``stable_topk`` on the card (the selection kernel, one launch) equals
    the full stable sort's first k, values bit for bit and indices, from
    rows as long as k to the serving cell's 384,546 (several segments)."""
    n = k if length == 'k' else length
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 1_000_003 + n * 131 + k)
    scores = torch.randn(rows, n, device=cuda_device, generator=gen)
    assert compare_select(f'{rows} x {n} k={k}', scores, k) == (1, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [10, 128, 1000, 4106, 384_546])
def test_selection_orders_ties_zeros_infinities_and_nan_as_the_sort(cuda_device, n):
    """Where the order rule decides: each row holding +-0, +-inf and NaN of
    both signs and several payloads, rows of four values, constant rows and
    rows of alternating -0.0 and +0.0; k in ``SELECT_KS`` up to the row."""
    rng = np.random.default_rng(n)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    zeros = torch.zeros(8, n, device=cuda_device)
    zeros[:, ::2] = -0.0
    for k in (k for k in SELECT_KS if k <= n):
        compare_select(f'specials n={n} k={k}', special_rows(rng, 64, n), k)
        compare_select(f'four values n={n} k={k}',
                       torch.randint(0, 4, (128, n), device=cuda_device, generator=gen).float(), k)
        compare_select(f'constant n={n} k={k}', torch.full((128, n), 0.5, device=cuda_device), k)
        compare_select(f'signed zeros n={n} k={k}', zeros, k)
        ascending = torch.arange(n, device=cuda_device, dtype=torch.float32).repeat(16, 1)
        compare_select(f'ascending n={n} k={k}', ascending, k)


@pytest.mark.cuda
def test_selection_takes_any_layout(cuda_device):
    """A transposed (non-contiguous) block, a 3-D block, rows starting at each
    float offset from 16-byte alignment, and k beyond the row (cut to it, as
    the sort's slice cuts it)."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    rows, n, k = SELECT_SHAPE
    compare_select('transposed', torch.randn(n, rows, device=cuda_device, generator=gen).T, k)
    compare_select('3-D', torch.randn(4, 32, 5000, device=cuda_device, generator=gen), k)
    flat = torch.randn(rows * n + 4, device=cuda_device, generator=gen)
    for offset in range(4):
        compare_select(f'offset {offset}', flat[offset:offset + rows * n].view(rows, n), k)
        compare_select(f'offset {offset}, n 4,107',
                       flat[offset:offset + 64 * 4107].view(64, 4107), k)
    values, indices = stable_topk(torch.randn(8, 50, device=cuda_device, generator=gen), 100)
    assert values.shape == indices.shape == (8, 50)
    before = stable_topk.launches
    values, indices = stable_topk(torch.randn(8, 50, device=cuda_device, generator=gen), 0)
    assert values.shape == indices.shape == (8, 0) and stable_topk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n,k', SELECT_LARGE)
def test_selection_takes_any_k(cuda_device, rows, n, k):
    """k past 128: one segment a row where pass 2 could not merge them,
    dynamic shared memory up to 128 KB, and rounds under a ceiling key past
    one block's buffer (the last round of several segments at k 7,977); bit
    for bit the stable sort's on normals, four values and special values."""
    gen = torch.Generator(device=cuda_device).manual_seed(rows * 7 + n + k)
    rng = np.random.default_rng(k)
    scores = torch.randn(rows, n, device=cuda_device, generator=gen)
    plan = select_plan(scores, k)
    assert plan.rounds == -(-k // plan.round_k) and plan.round_k == min(k, plan.round_k)
    assert compare_select(f'normals {rows} x {n} k={k}', scores, k) == (1, 0.0)
    few = torch.randint(0, 4, (rows, n), device=cuda_device, generator=gen).float()
    assert compare_select(f'four values {rows} x {n} k={k}', few, k) == (1, 0.0)
    assert compare_select(f'specials {rows} x {n} k={k}', special_rows(rng, rows, n), k) == (1, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float16, torch.bfloat16])
@pytest.mark.parametrize('rows,n,k', [(64, 10, 10), (64, 1000, 10), (128, 384_546, 10),
                                      (513, 4106, 128), (4, 100_000, 1025), (2, 30_000, 8000)])
def test_selection_of_16_bit_floats(cuda_device, dtype, rows, n, k):
    """float16 and bfloat16 keep their own bits: values equal the stable
    sort's bit for bit and indices equal, on normals (many ties at 16 bits)
    and on rows holding the dtype's NaN, infinities and signed zeros."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + k)
    rng = np.random.default_rng(n + k)
    scores = torch.randn(rows, n, device=cuda_device, generator=gen).to(dtype)
    assert compare_select(f'{dtype} normals {rows} x {n} k={k}', scores, k) == (1, 0.0)
    assert compare_select(f'{dtype} specials {rows} x {n} k={k}',
                          special_rows(rng, rows, n, dtype), k) == (1, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.float64, torch.int32, torch.int64, torch.bool])
def test_selection_rejects_other_dtypes_on_the_card(cuda_device, dtype):
    before = stable_topk.launches
    with pytest.raises(TypeError):
        stable_topk(torch.zeros(4, 100, device=cuda_device).to(dtype), 3)
    assert stable_topk.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('rows,n,k', [(128, 384_546, 10), (1, 384_546, 1), (513, 384_546, 128),
                                      (128, 4106, 10), (3, 10, 10), (1, 8192, 1),
                                      (2048, 2_000_000, 10), (1, 2 ** 31 - 1, 1)])
def test_select_plan_covers_each_row_in_aligned_segments(cuda_device, rows, n, k):
    """The library's plan: segments of a multiple of 4 elements cover the row
    with none empty; pass 2 merges at most 2,048 keys; several segments only
    where each is at least 4,096 long and the grid fits the card's resident
    blocks (at most 8 blocks of 256 threads an SM)."""
    plan = select_plan(torch.empty(1, device=cuda_device).expand(rows, n), k)
    segs, seg_len = plan.segments, plan.segment_length
    assert plan.rounds == 1 and plan.round_k == k
    assert seg_len % 4 == 0 and (segs - 1) * seg_len < n <= segs * seg_len
    assert segs * k <= 2048 and plan.scratch_keys == (rows * segs * k if segs > 1 else 0)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert segs == 1 or (rows * segs <= 8 * sms and seg_len >= 4096)


@pytest.mark.cuda
def test_select_plan_fills_the_card_once_at_the_serving_shape(cuda_device):
    """The serving cell's 128 rows of 384,546: several segments a row, the
    grid within one wave of resident blocks; 4,106 items take one."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    plan = select_plan(torch.empty(1, device=cuda_device).expand(128, 384_546), 10)
    assert plan.segments >= 2 and 128 * plan.segments <= 8 * sms
    assert select_plan(torch.empty(1, device=cuda_device).expand(128, 4106), 10).segments == 1


@pytest.mark.cuda
def test_dense_request_at_the_serving_shape_takes_one_selection(cuda_device):
    """``build_retrieval_fn`` at the serving cell's shape (384,546 items, D
    64, 128 users, k 10): the dense path, one selection launch and no
    top-k kernel launch, ids and scores equal to the stable sort's over the
    same score block."""
    from collie_tpu_torch import MatrixFactorizationModel
    from collie_tpu_torch.data import Interactions
    from collie_tpu_torch.retrieval import build_retrieval_fn

    rows, n, k = SELECT_SHAPE
    rng = np.random.default_rng(0)
    train = Interactions(users=rng.integers(0, 1000, 5000), items=rng.integers(0, n, 5000),
                         num_users=1000, num_items=n, allow_missing_ids=True, seed=0)
    model = MatrixFactorizationModel(train=train, embedding_dim=64, seed=0)
    users = torch.as_tensor(rng.choice(1000, rows, replace=False), device=model.device)
    retrieve = build_retrieval_fn(model, k=k)
    selections, kernel = stable_topk.launches, mf_topk_retrieve.launches
    ids, scores = retrieve(model.params, users)
    torch.cuda.synchronize()
    assert stable_topk.launches == selections + 1
    assert mf_topk_retrieve.launches == kernel
    with torch.no_grad():
        block = model.score_item_block(model.params, users,
                                       torch.arange(n, device=model.device))
    ref_scores, ref_ids = stable_topk_plain(block, k)
    assert torch.equal(ids, ref_ids)
    assert torch.equal(scores.view(torch.int32), ref_scores.contiguous().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize('D,k', [(1, 1), (64, 10), (256, 128), (1000, 128)])
def test_topk_plan_shared_bytes_match_the_kernel(cuda_device, D, k):
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (USER_CHUNKS, _library,
                                                               topk_shared_bytes)

    lib = _library()
    for chunk in USER_CHUNKS:
        for lists in (False, True):
            assert lib.collie_topk_shared_bytes(chunk, D, k, int(lists)) == \
                topk_shared_bytes(chunk, D, k, lists)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,shared_rows', [(GS_SHAPE, True), (GS_OVERSIZE, False)])
def test_gather_scatter_both_modes_match_plain_version(cuda_device, shape, shared_rows):
    """Bins in the clusters' shared memory (the microbench's shape) and bins
    too large for a cluster (rows in device memory), each against the plain
    version with ``chip_smoke.py``'s tolerances; the launch reports the
    mode the wrapper's plan names."""
    from collie_tpu_torch.ops.kernels.gather_scatter import (binned_gather_scatter,
                                                             binned_gather_scatter_plain,
                                                             gather_scatter_plan,
                                                             kept_examples, kernel_plan)

    iters, c_pad = 5, shape['c_pad']
    (tab_t, sids, offs, g_t), _ = gather_scatter_inputs(1, **shape)
    D, upad = tab_t.shape
    plan = gather_scatter_plan(D, upad, offs.shape[0] - 1, sids.shape[0], c_pad)
    assert plan.shared_rows == shared_rows
    assert kernel_plan(D, upad, offs.shape[0] - 1, sids.shape[0], c_pad) == plan
    out, gathered = binned_gather_scatter(tab_t, sids, offs, g_t, iters, c_pad)
    ref_out, ref_gathered = binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters, c_pad)
    torch.cuda.synchronize()
    assert binned_gather_scatter.last_plan == plan
    n_kept = int(kept_examples(sids, offs, upad, c_pad).sum())
    top = float(ref_out.abs().max())
    torch.testing.assert_close(out, ref_out, rtol=0, atol=GS_ATOL_SCALE * top)
    torch.testing.assert_close(gathered, ref_gathered, rtol=0,
                               atol=GS_ATOL_SCALE * n_kept * top)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [2, 3, 1024, 1025, 99_991])
@pytest.mark.parametrize('keys', SHUFFLE_KEY_SETS)
def test_cycle_walk_kernel_matches_plain_version(cuda_device, n, keys):
    from collie_tpu_torch.ops.shuffle import feistel_permutation_from_keys

    before = feistel_permutation_from_keys.launches
    check_cycle_walk(n, keys)
    assert feistel_permutation_from_keys.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('explicit', [False, True])
def test_skipped_launch_leaves_the_state_bit_identical(cuda_device, explicit):
    check_skipped_launch(explicit)


@pytest.mark.cuda
def test_whole_fit_on_the_card_reads_nothing_back_inside_a_flight(cuda_device, monkeypatch):
    from collie_tpu_torch import CollieTrainer, MatrixFactorizationModel, stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch
    from collie_tpu_torch.ops.shuffle import feistel_permutation_from_keys
    from collie_tpu_torch.training import trainer as trainer_module

    train, _ = stratified_split(generate_implicit_interactions(
        num_users=250, num_items=500, num_interactions=20_000, seed=1), test_p=0.2, seed=1,
        force_split=True)
    monkeypatch.setattr(trainer_module, 'flight_guard', sync_errors)
    model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-1, loss='adaptive',
                                     seed=0)
    before = fused_mf_epoch.launches, feistel_permutation_from_keys.launches
    trainer = CollieTrainer(model, max_epochs=5, verbosity=0, seed=0, terminate_on_nan=True,
                            early_stopping_patience=3)
    trainer.fit(model)
    torch.cuda.synchronize()
    assert trainer.num_epochs_completed >= 1
    assert fused_mf_epoch.launches - before[0] == 5
    assert feistel_permutation_from_keys.launches - before[1] == 5


@pytest.mark.cuda
def test_device_bucketed_tables_match_the_numpy_builder(cuda_device):
    """The bucketed sampler's tables built on the card equal the same
    builder's run on the CPU copies of the ids (which
    ``tests/test_torch_sampler_tables.py`` holds to collie_tpu's numpy
    builder) at ~1M pairs (skewed degrees, a user holding every item, users
    with none, repeated pairs, a shuffled order), and the build waits on the
    card once: its read of the buckets' sizes."""
    import warnings

    from collie_tpu_torch.ops.device_sampling import build_bucketed_complement_tables_torch

    rng = np.random.default_rng(17)
    num_users, num_items = 20_000, 10_681
    users = (num_users * rng.random(1_000_000) ** 3).astype(np.int64)
    items = rng.integers(0, num_items, users.shape[0])
    users = np.concatenate([users, np.full(num_items, 7), users[:50_000]])
    items = np.concatenate([items, np.arange(num_items), items[:50_000]])
    order = rng.permutation(users.shape[0])
    users, items = users[order], items[order]
    ref = build_bucketed_complement_tables_torch(torch.as_tensor(users), torch.as_tensor(items),
                                                 num_users, num_items)
    on_card = torch.as_tensor(users, device=cuda_device), torch.as_tensor(items,
                                                                          device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = build_bucketed_complement_tables_torch(*on_card, num_users, num_items)
    finally:
        torch.cuda.set_sync_debug_mode('default')
    assert sum('synchroniz' in str(w.message) for w in caught) == 1
    assert len(got[0]) == len(ref[0]) >= 6
    flat_got = [t for pair in got[0] for t in pair] + list(got[1:])
    flat_ref = [a for pair in ref[0] for a in pair] + list(ref[1:])
    for g, r in zip(flat_got, flat_ref):
        assert g.device.type == 'cuda' and g.dtype == r.dtype
        assert torch.equal(g.cpu(), r)


def _sample_both(problem, K, rounds, seed, device, specs=None):
    """The sampler kernel and its plain version on one set of uniforms
    (``sampler_uniforms``), the kernel's launches beside them."""
    from collie_tpu_torch.ops import device_sampling as sampling

    bucket_specs, counts, users_g, num_items = problem
    specs = bucket_specs if specs is None else specs
    width = K + sampling.SPARES_PER_ROUND * rounds
    u01 = torch.from_numpy(sampler_uniforms(users_g.shape[0], width, seed)).to(device)
    before = sampling.complement_sample_negatives_bucketed_grouped.launches
    got = sampling.complement_sample_negatives_bucketed_grouped(u01, users_g, specs, counts,
                                                                num_items, K, rounds)
    want = sampling.complement_sample_negatives_bucketed_grouped_plain(u01, users_g, specs,
                                                                       counts, num_items, K,
                                                                       rounds)
    torch.cuda.synchronize()
    return got, want, sampling.complement_sample_negatives_bucketed_grouped.launches - before


@pytest.mark.cuda
@pytest.mark.parametrize('K,rounds,chunk', SAMPLE_CASES)
def test_sampler_kernel_matches_plain_version(cuda_device, K, rounds, chunk):
    """Every slot's negatives value for value, in one launch over buckets of
    width 128 to 16,384: chunk-pad slots (chunk 256) and an odd N_g (chunk
    1), a user holding every item (the sentinel ``num_items``), rows built
    with three and more equal draws, so that duplicates remain."""
    problem = sampler_problem(chunk, cuda_device)
    specs, _, users_g, num_items = problem
    assert [t.shape[1] for _, t in specs] == [128 << b for b in range(8)]
    assert (users_g.shape[0] % 2 == 1) == (chunk == 1)
    got, want, launches = _sample_both(problem, K, rounds, K * 100 + rounds, cuda_device)
    assert launches == 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert int((got == num_items).sum()) >= K          # the full user's sentinel
    if rounds and K >= 4:
        residual = sum(int(row.numel() - row.unique().numel()) for row in got[::9].cpu())
        assert residual > 0                              # duplicates the spares left


@pytest.mark.cuda
def test_sampler_kernel_skips_an_empty_bucket(cuda_device):
    problem = sampler_problem(256, cuda_device)
    specs = problem[0]
    empty = (torch.empty(0, dtype=torch.int32, device=cuda_device), specs[1][1])
    with_empty = (empty,) + specs[:3] + (empty,) + specs[3:] + (empty,)
    got, want, launches = _sample_both(problem, 10, 1, 5, cuda_device, specs=with_empty)
    assert launches == 1 and torch.equal(got, want)
    assert torch.equal(got, _sample_both(problem, 10, 1, 5, cuda_device)[0])


@pytest.mark.cuda
def test_sampler_kernel_without_slots_launches_nothing(cuda_device):
    from collie_tpu_torch.ops import device_sampling as sampling

    empty = torch.empty(0, dtype=torch.int32, device=cuda_device)
    before = sampling.complement_sample_negatives_bucketed_grouped.launches
    got = sampling.complement_sample_negatives_bucketed_grouped(
        torch.empty((0, 12), device=cuda_device), empty, (), torch.zeros(3, dtype=torch.int32,
                                                                          device=cuda_device),
        500, 10, 1)
    assert got.shape == (0, 10) and got.dtype == torch.int32 and got.device.type == 'cuda'
    assert sampling.complement_sample_negatives_bucketed_grouped.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('slot_epoch', ['1', '0'])
def test_card_fit_with_the_sampler_kernel_equals_the_plain_sampler(cuda_device, monkeypatch,
                                                                   slot_epoch):
    """A 3-epoch MF fit on the card through the slot epoch (``1``: 256 users
    x 64 items, 16,384 pairs, no bucket pad) and through the reorder path
    (``COLLIE_TPU_SLOT_EPOCH=0``): bit-identical parameters with the
    sampler kernel and with the plain version forced in its place, and one
    kernel launch an epoch."""
    from collie_tpu_torch import CollieTrainer, Interactions, MatrixFactorizationModel
    from collie_tpu_torch.ops import device_sampling as sampling
    from collie_tpu_torch.training import scan_engine

    monkeypatch.setenv('COLLIE_TPU_SLOT_EPOCH', slot_epoch)
    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(256), 64)
    items = np.concatenate([rng.choice(500, 64, replace=False) for _ in range(256)])
    train = Interactions(users=users, items=items, num_users=256, num_items=500,
                         num_negative_samples=10, seed=1)
    reorders = []
    reorder = scan_engine.complement_sample_negatives_bucketed
    monkeypatch.setattr(scan_engine, 'complement_sample_negatives_bucketed',
                        lambda *a, **kw: reorders.append(1) or reorder(*a, **kw))

    def fit():
        model = MatrixFactorizationModel(train=train, embedding_dim=8, lr=1e-1,
                                         loss='adaptive', seed=0)
        CollieTrainer(model, max_epochs=3, verbosity=0, seed=7).fit(model)
        torch.cuda.synchronize()
        return {k: v.detach().clone() for k, v in model.params.items()}

    dispatch = sampling.complement_sample_negatives_bucketed_grouped
    before = dispatch.launches
    kernel = fit()
    assert dispatch.launches - before == 3
    assert (len(reorders) == 3) == (slot_epoch == '0')
    plain = sampling.complement_sample_negatives_bucketed_grouped_plain
    monkeypatch.setattr(sampling, 'complement_sample_negatives_bucketed_grouped', plain)
    monkeypatch.setattr(scan_engine, 'complement_sample_negatives_bucketed_grouped', plain)
    before = dispatch.launches
    reference = fit()
    assert dispatch.launches == before
    assert set(kernel) == set(reference)
    for name, value in kernel.items():
        assert torch.equal(value, reference[name]), name
