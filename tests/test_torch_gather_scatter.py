"""The binned gather/scatter port against the Pallas kernel it replaces.

``pk`` and ``pallas_binned`` (``benchmarks/microbench_gather.py:151-201``)
are closures inside that script's ``main()`` with its shapes as module
constants, so they are restated here verbatim with the shapes as
parameters and run in interpret mode on the CPU.  The TPU kernel's bin
window ``pl.ds(offs[j], C_PAD)`` runs past the arrays for the last bins;
interpret mode then clamps the slice start and the ids no longer line up
with their positions, so the restatement runs on ids and gradients padded
by ``C_PAD`` masked entries, the semantics the port defines.
``binned_gather_scatter_plain``'s ``out`` is held to it within 1e-5
absolute (sums of a few float32 gradients in another order), and its
``gathered`` to a numpy restatement within 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from collie_tpu_torch.ops.kernels.gather_scatter import (MAX_SHARED_BYTES, TARGET_BYTES,
                                                         GatherScatterPlan,
                                                         binned_gather_scatter,
                                                         binned_gather_scatter_plain,
                                                         gather_scatter_plan,
                                                         kept_examples)

ATOL = 1e-5


def pallas_binned_restated(tab_t, sids, offs, g, *, D, B, N_BINS, UB, UPAD, C_PAD, PITERS):
    """``microbench_gather.py:151-201``, verbatim but for the shapes, which
    are parameters here, and ``interpret=True``.  ``sids`` and ``g`` carry
    ``C_PAD`` padding entries past ``B``."""
    BP = B + C_PAD

    def pk(sids_ref, offs_ref, g_ref, tab_ref, out_ref):
        @pl.when(pl.program_id(0) == 0)
        def _():
            out_ref[:] = tab_ref[:]

        def bin_body(j, acc):
            o = offs_ref[0, j]
            w_ids = sids_ref[0, pl.ds(o, C_PAD)]
            sub = jax.lax.broadcasted_iota(jnp.int32, (C_PAD, UB), 1)
            pos = jax.lax.broadcasted_iota(jnp.int32, (C_PAD, UB), 0) + o
            local = w_ids - j * UB
            oh = jnp.where((sub == local[:, None])
                           & (pos < offs_ref[0, j + 1]), 1.0, 0.0)
            # gather: [D, UB] @ [UB, C_PAD]^T -> [D, C_PAD]
            rows = jax.lax.dot_general(
                out_ref[:, pl.ds(j * UB, UB)], oh, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            # scatter: [D, C_PAD] @ [C_PAD, UB] -> [D, UB]
            w_g = g_ref[:, pl.ds(o, C_PAD)]
            blk = jax.lax.dot_general(
                w_g, oh, (((1,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
            out_ref[:, pl.ds(j * UB, UB)] = \
                out_ref[:, pl.ds(j * UB, UB)] + blk
            return acc + jnp.sum(rows[:8, :128])
        jax.lax.fori_loop(0, N_BINS, bin_body, jnp.float32(0.))

    @jax.jit
    def pallas_binned(tp, si, of, g):
        return pl.pallas_call(
            pk, grid=(PITERS,),
            in_specs=[
                pl.BlockSpec((1, BP), lambda s: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((1, N_BINS + 1), lambda s: (0, 0),
                             memory_space=pltpu.SMEM),
                pl.BlockSpec((D, BP), lambda s: (0, 0),
                             memory_space=pltpu.VMEM),
                pl.BlockSpec((D, UPAD), lambda s: (0, 0),
                             memory_space=pltpu.VMEM),
            ],
            out_specs=pl.BlockSpec((D, UPAD), lambda s: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((D, UPAD), jnp.float32),
            interpret=True,
        )(si.reshape(1, BP), of.reshape(1, N_BINS + 1), g, tp)

    return np.asarray(pallas_binned(jnp.asarray(tab_t), jnp.asarray(sids), jnp.asarray(offs),
                                    jnp.asarray(g)))


def make_inputs(seed, *, U=1000, D=8, B=256, N_BINS=4, C_PAD=128, ids=None):
    """The microbench's inputs at a small shape: a table ``[D, UPAD]`` with
    zeros past U, ids stably sorted by bin, bin offsets and gradient
    columns in the sorted order."""
    rng = np.random.default_rng(seed)
    UB = -(-U // N_BINS // 128) * 128
    UPAD = N_BINS * UB
    if ids is None:
        ids = rng.integers(0, U, B)
    ids = np.asarray(ids, np.int32)
    tab = np.zeros((D, UPAD), np.float32)
    tab[:, :U] = rng.standard_normal((D, U)).astype(np.float32)
    grads = rng.standard_normal((len(ids), D)).astype(np.float32)
    order = np.argsort(ids // UB, kind='stable')
    sids, sg_t = ids[order], np.ascontiguousarray(grads[order].T)
    counts = np.bincount(ids // UB, minlength=N_BINS)
    offs = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    shape = dict(D=D, B=len(ids), N_BINS=N_BINS, UB=UB, UPAD=UPAD, C_PAD=C_PAD)
    return tab, sids, offs, sg_t, shape


def reference_out(tab, sids, offs, sg_t, shape, iters):
    """The restated Pallas kernel on inputs padded by C_PAD masked entries."""
    C_PAD = shape['C_PAD']
    sids_p = np.concatenate([sids, np.zeros(C_PAD, np.int32)])
    g_p = np.concatenate([sg_t, np.zeros((shape['D'], C_PAD), np.float32)], axis=1)
    return pallas_binned_restated(tab, sids_p, offs, g_p, PITERS=iters, **shape)


def port(tab, sids, offs, sg_t, shape, iters):
    return binned_gather_scatter(torch.from_numpy(tab), torch.from_numpy(sids),
                                 torch.from_numpy(offs), torch.from_numpy(sg_t), iters,
                                 shape['C_PAD'])


CASES = {
    'uniform ids': dict(),
    # bin 0 holds 200 of the 256 examples: its last 72 fall outside the window
    'overflowing bin': dict(ids=np.concatenate([np.arange(200) % 256,
                                                np.arange(56) * 12 + 300])),
    'duplicate ids': dict(ids=np.repeat(np.arange(0, 1000, 31), 8)[:256]),
    # no id falls in bin 2 (rows 512..767)
    'empty bin': dict(ids=np.concatenate([np.arange(128) * 4, np.arange(128) + 800])),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_out_matches_the_pallas_kernel(case):
    iters = 3
    tab, sids, offs, sg_t, shape = make_inputs(len(case), **CASES[case])
    ref = reference_out(tab, sids, offs, sg_t, shape, iters)
    out, gathered = port(tab, sids, offs, sg_t, shape, iters)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=ATOL)
    assert gathered.shape == (iters, shape['D'])


def test_overflowing_bin_drops_the_examples_past_the_window():
    tab, sids, offs, sg_t, shape = make_inputs(1, **CASES['overflowing bin'])
    kept = kept_examples(torch.from_numpy(sids), torch.from_numpy(offs), shape['UPAD'],
                         shape['C_PAD']).numpy()
    assert offs[1] == 200 and kept[:128].all() and not kept[128:200].any() and kept[200:].all()
    # a row touched only past the window keeps its value
    dropped = set(sids[128:200]) - set(sids[:128]) - set(sids[200:])
    out, _ = port(tab, sids, offs, sg_t, shape, 2)
    for i in dropped:
        np.testing.assert_array_equal(out[:, i].numpy(), tab[:, i])


def test_gathered_matches_a_numpy_restatement():
    iters = 4
    tab, sids, offs, sg_t, shape = make_inputs(5, **CASES['overflowing bin'])
    kept = kept_examples(torch.from_numpy(sids), torch.from_numpy(offs), shape['UPAD'],
                         shape['C_PAD']).numpy()
    state = tab.astype(np.float64)
    want = np.zeros((iters, shape['D']))
    for t in range(iters):
        want[t] = state[:, sids[kept]].sum(axis=1)
        np.add.at(state.T, sids[kept], sg_t[:, kept].T.astype(np.float64))
    out, gathered = port(tab, sids, offs, sg_t, shape, iters)
    np.testing.assert_allclose(gathered.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out.numpy(), state, rtol=0, atol=ATOL)


def test_plain_version_is_the_cpu_path():
    tab, sids, offs, sg_t, shape = make_inputs(2)
    args = [torch.from_numpy(a) for a in (tab, sids, offs, sg_t)]
    before = binned_gather_scatter.launches
    out, gathered = binned_gather_scatter(*args, 2, shape['C_PAD'])
    ref_out, ref_gathered = binned_gather_scatter_plain(*args, 2, shape['C_PAD'])
    assert binned_gather_scatter.launches == before
    assert torch.equal(out, ref_out) and torch.equal(gathered, ref_gathered)


def test_wrapper_raises_for_other_devices_and_bad_inputs():
    tab, sids, offs, sg_t, shape = make_inputs(3)
    args = [torch.from_numpy(a) for a in (tab, sids, offs, sg_t)]
    with pytest.raises(ValueError, match='runs on cuda or cpu'):
        binned_gather_scatter(*[a.to('meta') for a in args], 1, shape['C_PAD'])
    with pytest.raises(TypeError, match='int32'):
        binned_gather_scatter(args[0], args[1].long(), args[2], args[3], 1, shape['C_PAD'])
    with pytest.raises(ValueError, match='g_t must be'):
        binned_gather_scatter(*args[:3], args[3][:, :-1], 1, shape['C_PAD'])
    with pytest.raises(ValueError, match='multiple of n_bins'):
        binned_gather_scatter(args[0][:, :-1], *args[1:], 1, shape['C_PAD'])


def _plan_of(shape):
    """The plan for ``chip_smoke``'s inputs at ``shape``, without building them."""
    U, D, B, n_bins = shape['U'], shape['D'], shape['B'], shape['n_bins']
    ub = -(-U // n_bins // 128) * 128
    return gather_scatter_plan(D, n_bins * ub, n_bins, B, shape['c_pad'])


def test_cluster_plan_for_the_microbench_shape():
    """The microbench's bins (4,608 rows of D = 32, 590 KB each) are split
    over clusters of 8 blocks, rows and example cache in shared memory."""
    from chip_smoke import GS_SHAPE

    plan = _plan_of(GS_SHAPE)
    assert plan == GatherScatterPlan(shared_rows=True, cache=True, cluster=8,
                                     shared_bytes=4 * (32 + 576 * 33 + 96 * 34))
    assert plan.mode == 'shared rows' and plan.shared_bytes <= MAX_SHARED_BYTES


def test_cluster_plan_for_a_bin_too_large_for_a_cluster():
    """``chip_smoke.GS_OVERSIZE``'s bins (18,048 rows, 2.3 MB) exceed the
    shared memory of a cluster of 8: rows stay in device memory, the
    example cache in shared memory; with a window too large to cache, not
    even that."""
    from chip_smoke import GS_OVERSIZE

    plan = _plan_of(GS_OVERSIZE)
    assert plan == GatherScatterPlan(shared_rows=False, cache=True, cluster=8,
                                     shared_bytes=4 * (32 + 320 * 34))
    assert plan.mode == 'device rows'
    huge = gather_scatter_plan(32, 72192, 4, 10_000_000, 2_000_000)
    assert huge == GatherScatterPlan(False, False, 8, 4 * 32)


@pytest.mark.parametrize('D,upad,n_bins,B,c_pad', [
    (8, 1024, 4, 256, 128),           # the CPU tests' shape
    (33, 3072, 4, 700, 128),          # the card tests' shape
    (32, 73728, 16, 8192, 768),       # the microbench's
    (64, 65536, 16, 4096, 512),
    (32, 32768, 16, 4096, 512),
    (256, 4096, 4, 1024, 256),        # D = 256: over 96 KB even at 8 blocks
])
def test_cluster_plan_takes_the_smallest_cluster_under_96_kb(D, upad, n_bins, B, c_pad):
    """The cluster is the smallest of 1, 2, 4, 8 blocks whose share of a
    bin's rows (odd rows of ``D | 1`` floats) and of its window of examples
    (``D | 1`` gradients and a row index each) stays under 96 KB, else 8."""
    ub, stride, window = upad // n_bins, D | 1, min(c_pad, B)

    def block_bytes(cs):
        return 4 * (D + -(-ub // cs) * stride + -(-window // cs) * (stride + 1))

    want = next((cs for cs in (1, 2, 4, 8) if block_bytes(cs) <= TARGET_BYTES), 8)
    plan = gather_scatter_plan(D, upad, n_bins, B, c_pad)
    assert plan.cluster == want
    assert plan.shared_rows and plan.cache and plan.shared_bytes == block_bytes(want)
    assert plan.shared_bytes <= MAX_SHARED_BYTES
