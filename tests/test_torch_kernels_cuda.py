"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The fused epoch's edge shapes, inputs and tolerance are
``chip_smoke.py``'s.  The file imports no JAX, so it also runs on a machine
without it:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import EPOCH_EDGES, compare_epoch, epoch_inputs
from collie_tpu_torch.ops.kernels.retrieval_kernel import (mf_topk_retrieve,
                                                           mf_topk_retrieve_plain)

EDGE_ENVELOPES = [(37, 257, 10), (1, 64, 5), (9, 4096, 10), (16, 128, 128)]


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
    Adam amplifies), per-epoch losses within rtol 1e-4."""
    from collie_tpu_torch import (CollieTrainer, MatrixFactorizationModel, stratified_split)
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions
    from collie_tpu_torch.training import scan_engine

    def numpy_draws(seed, epoch_idx, training, device, perm_n, sample_shape, num_items, exact):
        rng = np.random.default_rng((seed, epoch_idx, int(training)))
        keys = torch.from_numpy(rng.integers(0, 2 ** 31 - 1, 4)).to(device) if perm_n else None
        u01 = torch.from_numpy(rng.random(sample_shape, dtype=np.float32)).to(device)
        return keys, u01

    monkeypatch.setattr(scan_engine, 'draw_epoch', numpy_draws)
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
