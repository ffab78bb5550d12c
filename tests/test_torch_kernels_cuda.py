"""The CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (the kernels have no CPU mode) and skip
without one.  The file imports only torch and numpy, so it also runs on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

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
