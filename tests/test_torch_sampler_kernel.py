"""The bucketed sampler's dispatch without a card: CPU tensors take the
plain version and launch nothing, CUDA tensors take the kernel at any
width and bucket count, and the kernel's wrapper raises on what it does
not take before it reaches for the card.  Its
values are held to the plain version on the card
(``tests/test_torch_kernels_cuda.py``) and the plain version to collie_tpu's
on the CPU (``tests/test_torch_sampling.py``)."""
import pytest
import torch

from chip_smoke import sampler_problem, sampler_uniforms
from collie_tpu_torch.ops import device_sampling as sampling

K, ROUNDS = 10, 1
WIDTH = K + sampling.SPARES_PER_ROUND * ROUNDS


@pytest.fixture(scope='module')
def problem():
    return sampler_problem(256, 'cpu')


def _uniforms(problem, width=WIDTH):
    return torch.from_numpy(sampler_uniforms(problem[2].shape[0], width, 9))


def test_cpu_tensors_take_the_plain_version(problem):
    specs, counts, users_g, num_items = problem
    u01 = _uniforms(problem)
    before = sampling.complement_sample_negatives_bucketed_grouped.launches
    got = sampling.complement_sample_negatives_bucketed_grouped(u01, users_g, specs, counts,
                                                                num_items, K, ROUNDS)
    want = sampling.complement_sample_negatives_bucketed_grouped_plain(u01, users_g, specs,
                                                                       counts, num_items, K,
                                                                       ROUNDS)
    assert sampling.complement_sample_negatives_bucketed_grouped.launches == before
    assert got.dtype == torch.int32 and torch.equal(got, want)


class _OnCard:
    """Stands for a CUDA tensor in the dispatch alone: a shape and a device."""

    def __init__(self, shape):
        self.shape = torch.Size(shape)
        self.device = torch.device('cuda')


@pytest.mark.parametrize('k,rounds,buckets', [
    (10, 1, 8), (62, 1, 8), (60, 2, 8), (63, 1, 8), (65, 0, 8), (300, 3, 1), (10, 1, 40),
    (0, 1, 8),
])
def test_cuda_tensors_take_the_kernel_at_any_shape(monkeypatch, k, rounds, buckets):
    """Every CUDA input goes to the kernel's wrapper, which raises on what
    the kernel does not take (K = 0, more buckets than any table plan
    makes): none falls back to the plain version on the card."""
    called = []
    for name in ('cuda', 'plain'):
        monkeypatch.setattr(sampling, f'complement_sample_negatives_bucketed_grouped_{name}',
                            lambda *a, _name=name, **kw: called.append(_name))
    n = 100
    users_g = torch.zeros(n, dtype=torch.int32)
    specs = ((torch.zeros(n, dtype=torch.int32), torch.zeros(1, 128, dtype=torch.int32)),) * buckets
    sampling.complement_sample_negatives_bucketed_grouped(
        _OnCard((n, k + sampling.SPARES_PER_ROUND * rounds)), users_g, specs,
        torch.zeros(1, dtype=torch.int32), 500, k, rounds)
    assert called == ['cuda']


def _bad_inputs(problem, how):
    """The wrapper's arguments, with one thing it does not take."""
    specs, counts, users_g, num_items = problem
    u01, width = _uniforms(problem), WIDTH
    if how == 'u01 float64':
        u01 = u01.double()
    elif how == 'users_g int64':
        users_g = users_g.long()
    elif how == 'table int64':
        specs = ((specs[0][0], specs[0][1].long()),) + specs[1:]
    elif how == 'u01 shape':
        u01 = u01[:, :-1]
    elif how == 'row_idx rank':
        specs = ((specs[0][0][:, None], specs[0][1]),) + specs[1:]
    elif how == 'slots':
        specs = specs[:-1]
    elif how == 'u01 not contiguous':
        u01 = u01.t().contiguous().t()
    elif how == 'table not contiguous':
        specs = ((specs[0][0], specs[0][1].t().contiguous().t()),) + specs[1:]
    elif how == 'no negatives':
        width = sampling.SPARES_PER_ROUND
        u01 = _uniforms(problem, width)
    elif how == 'on the CPU':
        pass
    return u01, users_g, specs, counts, num_items, width - sampling.SPARES_PER_ROUND, ROUNDS


@pytest.mark.parametrize('how,error,match', [
    ('u01 float64', TypeError, 'u01 as torch.float32'),
    ('users_g int64', TypeError, 'users_g as torch.int32'),
    ('table int64', TypeError, r'table\[0\] as torch.int32'),
    ('u01 shape', ValueError, 'u01 must be'),
    ('row_idx rank', ValueError, r'row_idx\[0\] of another rank'),
    ('slots', ValueError, 'the buckets hold'),
    ('u01 not contiguous', ValueError, 'u01 contiguous'),
    ('table not contiguous', ValueError, r'table\[0\] contiguous'),
    ('no negatives', ValueError, 'num_negative_samples >= 1'),
    ('on the CPU', ValueError, 'one CUDA device'),
])
def test_the_kernels_wrapper_raises_before_the_launch(problem, how, error, match):
    before = sampling.complement_sample_negatives_bucketed_grouped.launches
    with pytest.raises(error, match=match):
        sampling.complement_sample_negatives_bucketed_grouped_cuda(*_bad_inputs(problem, how))
    assert sampling.complement_sample_negatives_bucketed_grouped.launches == before
