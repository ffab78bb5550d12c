"""Drive collie_tpu_torch's serving and training paths on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA card (written
for the H100):

    python3 chip_smoke.py [--seed N]

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the result line:

1. device: card name and power limit, TF32 switched off for matmuls and cuDNN;
2. build: every CUDA kernel of the paths, compiled from
   ``collie_tpu_torch/csrc`` (one nvcc per source, all started together);
3. kernels: ``topk_tile`` against its plain PyTorch version at the edge
   shapes of the JAX package's tests, a tie case and the serving shape;
   ``fused_mf_epoch`` against its plain version at edge shapes (every loss
   kind, metadata, weight decay, K=1, duplicate ids, B not a power of two)
   and at the ML-10M training shape after 3 steps and after one full
   epoch of the engine's real batches; times for each kernel, its plain
   version and (where one exists) one library call of the same function;
4. serving: an MF model at the repo's serving scale (2,000,000 items,
   ``embedding_dim=64``, random weights from the seed) is built from seeded
   interactions, saved to npz and loaded back, then answers four
   ``recommend`` requests of 256 users without seen filtering (the kernel
   path, shown by the launch counter) and two with it (the blockwise path),
   each checked against a dense stable top-k, and runs
   ``evaluate_in_batches`` on 2,048 test users;
5. training: (a) the quality-gate configuration of ``bench.py`` (943 users
   x 1,682 items, ``embedding_dim=10``, batch 1,024, adaptive hinge, K=10)
   fit for 10 epochs through ``CollieTrainer``, whose ``evaluate_in_batches``
   MAP@10, MRR and AUC must clear ``benchmarks/gates.json``; (b) the
   ML-10M-scale configuration of ``benchmarks/bench_ml10m_scale.py`` (72,000
   users x 10,000 items, 10M generated interactions, 90/5/5 split,
   ``embedding_dim=32``, batch 65,536) fit for 3 epochs, with examples/s,
   each epoch's time split into epoch building and kernel, peak memory, and
   a trained-beats-untrained MAP@10 check.  The fused kernel's launch
   counter must equal the epochs the two fits ran;
6. the kernels line (one JSON object), the card's name and power limit, and
   as the last line ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit) used for the
# bound: FP32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

RTOL = 1e-5
ATOL = 1e-5
DEVICE = 'cuda'

NUM_USERS = 100_000
NUM_ITEMS = 2_000_000            # benchmarks/retrieval_results.json catalog_2000000
EMBEDDING_DIM = 64
NUM_INTERACTIONS = 5_000_000
REQUEST_USERS = 256
EVAL_USERS = 2_048
K = 10

# training: the quality-gate configuration of bench.py:24-49 and the
# ML-10M-scale configuration of benchmarks/bench_ml10m_scale.py:34-72
GATE_DATA = dict(num_users=943, num_items=1682, num_interactions=100_000,
                 num_negative_samples=10, seed=42)
GATE_EPOCHS = 10
ML10M_DATA = dict(num_users=72_000, num_items=10_000, num_interactions=10_000_000,
                  num_negative_samples=10, affinity_bias=3.0, seed=7)
ML10M_BATCH = 65_536
ML10M_DIM = 32
ML10M_EPOCHS = 3
ML10M_EVAL_USERS = 5_000
SPLIT = ('shuffle_ms', 'sample_ms', 'train_ms')     # CollieTrainer.epoch_log

# fused_mf_epoch against its plain version: tables and moments within
# EPOCH_RTOL * |ref| + EPOCH_ATOL_SCALE * max|ref| per tensor (atomics sum
# duplicate ids in a run-dependent order), per-step losses within
# EPOCH_RTOL.  At the ML-10M shape a rounding-level score difference can
# flip an example's hardest-negative choice, which moves that example's
# rows by an Adam step; there at most MAX_FLIPPED_FRACTION of each tensor's
# elements may fall outside the tolerance.
EPOCH_RTOL = 1e-4
EPOCH_ATOL_SCALE = 1e-5
MAX_FLIPPED_FRACTION = 1e-3
# (loss_kind, adaptive, K, B, D, metadata fields, weight decay, duplicate ids)
EPOCH_EDGES = [
    ('hinge', False, 1, 7, 10, 0, 0.0, False),
    ('hinge', True, 4, 100, 10, 0, 0.0, False),
    ('bpr', False, 4, 100, 33, 0, 0.0, False),
    ('bpr', True, 4, 37, 64, 0, 1e-3, False),
    ('warp', False, 5, 100, 32, 0, 0.0, False),
    ('hinge', True, 4, 100, 16, 2, 0.0, True),
    ('warp', False, 6, 61, 8, 2, 1e-3, True),
    ('bpr', False, 1, 1, 256, 1, 0.0, False),
]


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_median_ms(fn, warmup: int = 2, runs: int = 7) -> float:
    """Median over warm runs of one call, timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check_topk(name, ids, scores, ref_ids, ref_scores, ref_next):
    """Hold ``(ids, scores) [B, k]`` to a reference top-k.

    Scores must agree within ``RTOL``/``ATOL``.  Ids must be equal, except
    in a row whose reference k-th and (k+1)-th scores (``ref_next`` is the
    (k+1)-th) differ by less than the tolerance: there the last place is a
    near-tie that rounding may decide either way.  Returns the max abs error.
    """
    ids, ref_ids = ids.long().cpu(), ref_ids.long().cpu()
    scores, ref_scores, ref_next = scores.cpu(), ref_scores.cpu(), ref_next.cpu()
    if ids.shape != ref_ids.shape or scores.shape != ref_scores.shape:
        raise AssertionError(f'{name}: shape {tuple(ids.shape)} vs {tuple(ref_ids.shape)}')
    if not torch.isfinite(scores).all():
        raise AssertionError(f'{name}: non-finite scores')
    max_err = float((scores - ref_scores).abs().max())
    if not torch.allclose(scores, ref_scores, rtol=RTOL, atol=ATOL):
        raise AssertionError(f'{name}: scores differ by up to {max_err}')
    bad_rows = (ids != ref_ids).any(dim=1)
    gap = ref_scores[:, -1] - ref_next
    near_tie = gap.abs() <= ATOL + RTOL * ref_scores[:, -1].abs()
    if (bad_rows & ~near_tie).any():
        rows = torch.nonzero(bad_rows & ~near_tie).flatten()[:5].tolist()
        raise AssertionError(f'{name}: ids differ in rows {rows}')
    log(f'  {name}: ids equal in {int((~bad_rows).sum())}/{len(ids)} rows '
        f'({int(bad_rows.sum())} near-tie rows excused), max_abs_err={max_err:.3g}')
    return max_err


def phase_device():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this check needs a '
              'CUDA card', file=sys.stderr)
        sys.exit(2)
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f'nvidia-smi: {smi}')
    log(f'torch {torch.__version__} cuda {torch.version.cuda} device '
        f'{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}')
    log(f'torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
        f'torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    torch.cuda.synchronize()
    return smi


def phase_build():
    from collie_tpu_torch.ops.kernels import _build

    sources = sorted(p.name for p in _build.CSRC.glob('*.cu'))
    start = time.perf_counter()
    # one nvcc per source, all started together
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - start
    for source, path in zip(sources, paths):
        log(f'built {source} -> {path.name}')
        report = _build.build_log.get(source, (0.0, 'already built'))[1]
        regs = [line.strip() for line in report.splitlines() if 'registers' in line]
        for line in regs:
            log(f'  ptxas: {line}')
    log(f'build_seconds={seconds:.2f}')
    for source in sources:
        _build.load(source)
    torch.cuda.synchronize()


def _rand(rng, shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32), device='cuda')


def phase_kernels():
    """topk_tile against its plain version; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import (
        mf_topk_retrieve, mf_topk_retrieve_plain, stable_topk, topk_tiles_cuda)

    max_err = 0.0
    log(f'kernel topk_tile vs plain (rtol={RTOL}, atol={ATOL})')

    def compare(label, ue, ub, ie, ib, k, tile):
        ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=k, tile=tile)
        if k + 1 <= min(128, ie.shape[0]):
            _, plain_next = mf_topk_retrieve_plain(ue, ub, ie, ib, k=k + 1, tile=tile)
            plain_next = plain_next[:, k]
        else:
            plain_next = torch.full((ue.shape[0],), float('-inf'), device='cuda')
        p_ids, p_scores = mf_topk_retrieve_plain(ue, ub, ie, ib, k=k, tile=tile)
        torch.cuda.synchronize()
        return check_topk(label, ids, scores, p_ids, p_scores, plain_next)

    # edge envelopes of tests/test_retrieval.py::test_pallas_kernel_edge_envelopes
    for B, tile, k in ((37, 257, 10), (1, 64, 5), (9, 4096, 10), (16, 128, 128)):
        rng = np.random.default_rng(B * 1000 + tile + k)
        ue, ub = _rand(rng, (B, 12)), _rand(rng, (B,))
        ie, ib = _rand(rng, (611, 12)), _rand(rng, (611,))
        max_err = max(max_err, compare(f'B={B} tile={tile} k={k}', ue, ub, ie, ib, k, tile))

    # ties: duplicated item rows and biases on a coarse grid, so every sum is
    # exact in float32 whatever its order and the tie-break alone decides
    rng = np.random.default_rng(7)
    grid = lambda shape: torch.tensor(  # noqa: E731
        rng.integers(-2, 3, shape).astype(np.float32) / 4, device='cuda')
    ue, ub = grid((24, 12)), grid((24,))
    ie, ib = grid((611, 12)), grid((611,))
    ie[300:600], ib[300:600] = ie[:300].clone(), ib[:300].clone()
    ids, scores = mf_topk_retrieve(ue, ub, ie, ib, k=40, tile=128)
    full = ue @ ie.T + ub[:, None] + ib[None, :]
    ref_scores, ref_ids = stable_topk(full, 40)
    torch.cuda.synchronize()
    if not torch.equal(ids.long(), ref_ids) or not torch.equal(scores, ref_scores):
        raise AssertionError('tie case: kernel ids/scores differ from the stable top-k')
    log('  ties: ids and scores equal to the dense stable top-k (lowest id first)')

    # serving shape
    B, I, D, k, tile = REQUEST_USERS, NUM_ITEMS, EMBEDDING_DIM, K, 4096
    rng = np.random.default_rng(11)
    ue, ub, ie, ib = _rand(rng, (B, D)), _rand(rng, (B,)), _rand(rng, (I, D)), _rand(rng, (I,))
    max_err = max(max_err, compare(f'serving B={B} I={I} D={D} k={k} tile={tile}',
                                   ue, ub, ie, ib, k, tile))

    def library():
        return torch.topk(ue @ ie.T + ub[:, None] + ib[None, :], k, dim=1)

    kernel_ms = cuda_median_ms(lambda: mf_topk_retrieve(ue, ub, ie, ib, k=k, tile=tile))
    kernel_only_ms = cuda_median_ms(lambda: topk_tiles_cuda(ue, ie, ib, k, tile))
    plain_ms = cuda_median_ms(lambda: mf_topk_retrieve_plain(ue, ub, ie, ib, k=k, tile=tile),
                              warmup=1, runs=3)
    library_ms = cuda_median_ms(library)
    # where the kernel's time goes: scoring is the same for every k, each
    # selection round adds a scan of the tile per user
    by_k = {kk: cuda_median_ms(lambda kk=kk: topk_tiles_cuda(ue, ie, ib, kk, tile),
                               warmup=1, runs=5) for kk in (1, 10, 128)}
    log('  kernel launch alone by k: ' + ', '.join(f'k={kk} {ms:.4f} ms'
                                                    for kk, ms in by_k.items()))
    ops = 2.0 * B * I * D + B * I               # FMAs of the dots + the item bias
    nbytes = 4.0 * (B * D + B + I * D + I) + 8.0 * B * k
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f'  serving shape: kernel_ms={kernel_ms:.4f} (kernel launch alone '
        f'{kernel_only_ms:.4f}, the rest is the tile merge) plain_ms={plain_ms:.4f} '
        f'library_ms={library_ms:.4f} (matmul + bias + torch.topk) '
        f'bound_ms={bound_ms:.4f} (operations {ops_ms:.4f}, bytes {bytes_ms:.4f})')
    del ue, ub, ie, ib
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'topk_tile',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/topk_tile.cu',
        'replaces': 'collie_tpu/ops/pallas/retrieval_kernel.py:36',
        'launches': 0,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': library_ms,
        'checked': True,
    }


def epoch_inputs(seed, U=37, I=53, D=10, S=3, B=7, K=1, F=0, dup=False):
    """Tables, moments and batches of ``fused_mf_epoch`` on the card, from a
    numpy seed."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=0.1):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    users = rng.integers(0, U, (S, B)).astype(np.int32)
    pos = rng.integers(0, I, (S, B)).astype(np.int32)
    negs = rng.integers(0, I, (S, B, K)).astype(np.int32)
    if dup:
        users[:, :(B + 1) // 2] = users[:, :1]
        pos[:, :(B + 1) // 2] = pos[:, :1]
    mask = np.ones((S, B), np.float32)
    mask[-1, B // 2:] = 0.0
    arrays = [f(U, D), f(I, D), f(I), f(U, D, scale=1e-3), np.abs(f(U, D, scale=1e-4)),
              f(I, D, scale=1e-3), np.abs(f(I, D, scale=1e-4))]
    tensors = [torch.from_numpy(a).to(DEVICE) for a in arrays]
    tensors.append(torch.tensor(5, dtype=torch.int32, device=DEVICE))
    tensors += [torch.from_numpy(a).to(DEVICE) for a in (users, pos, negs, mask)]
    tensors += [0.05, 0.01]
    meta = torch.from_numpy(rng.integers(0, 3, (F, I)).astype(np.int32)).to(DEVICE) if F else None
    return tensors, meta


def compare_epoch(label, out, ref, max_flipped=0.0, quiet=False):
    """Hold ``fused_mf_epoch``'s outputs to the plain version's; returns the
    max abs error over tables and moments."""
    names = ['user_emb', 'item_emb', 'item_bias', 'mu_u', 'nu_u', 'mu_i', 'nu_i']
    max_err, report = 0.0, []
    for name, a, b in zip(names, out[:7], ref[:7]):
        diff = (a - b).abs()
        tol = EPOCH_RTOL * b.abs() + EPOCH_ATOL_SCALE * b.abs().max()
        if not torch.isfinite(a).all():
            raise AssertionError(f'{label}: non-finite {name}')
        flipped = float((diff > tol).float().mean())
        if flipped > max_flipped:
            raise AssertionError(f'{label}: {name} differs beyond tolerance in {flipped:.3%} '
                                 f'of elements (max abs {float(diff.max()):.3g})')
        max_err = max(max_err, float(diff.max()))
        report.append(f'{name} {flipped:.2e}')
    if int(out[7]) != int(ref[7]):
        raise AssertionError(f'{label}: count {int(out[7])} vs {int(ref[7])}')
    if not torch.allclose(out[8], ref[8], rtol=EPOCH_RTOL, atol=1e-7):
        raise AssertionError(f'{label}: per-step losses differ: {out[8][:5].tolist()} vs '
                             f'{ref[8][:5].tolist()}')
    if not quiet:
        log(f'  {label}: max_abs_err={max_err:.3g}; share of elements beyond tolerance: '
            + ', '.join(report))
    return max_err


def ml10m_data():
    """The ML-10M-scale configuration's data, as bench_ml10m_scale.py builds
    it: generated interactions, then a 90/5/5 stratified split."""
    from collie_tpu_torch.data import stratified_split
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions

    start = time.perf_counter()
    inter = generate_implicit_interactions(**ML10M_DATA)
    train, val, test = stratified_split(inter, val_p=0.05, test_p=0.05, seed=7,
                                        force_split=True)
    log(f'ML-10M-scale data: {train.num_interactions} train / {val.num_interactions} val / '
        f'{test.num_interactions} test interactions, {train.num_users} users x '
        f'{train.num_items} items ({time.perf_counter() - start:.1f}s on the host)')
    return train, val, test


def ml10m_model(train):
    from collie_tpu_torch import InteractionsDataLoader, MatrixFactorizationModel

    loader = InteractionsDataLoader(interactions=train, batch_size=ML10M_BATCH, shuffle=True,
                                    seed=7)
    return MatrixFactorizationModel(train=loader, embedding_dim=ML10M_DIM, lr=1e-1,
                                    loss='adaptive', seed=7)


def phase_kernel_fused_epoch(ml10m):
    """fused_mf_epoch against its plain version; returns the kernel's record."""
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import (fused_mf_epoch,
                                                             fused_mf_epoch_plain)
    from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns

    log(f'kernel fused_mf_epoch vs plain (rtol={EPOCH_RTOL}, atol={EPOCH_ATOL_SCALE} x '
        f'max|ref|)')
    max_err = 0.0
    for loss_kind, adaptive, K, B, D, F, wd, dup in EPOCH_EDGES:
        args, meta = epoch_inputs(K * 100 + B + D, D=D, B=B, K=K, F=F, dup=dup)
        kw = dict(K=K, adaptive=adaptive, loss_kind=loss_kind,
                  meta_weights=(0.3, 0.2)[:F] if F != 1 else (0.5,), wd_emb=wd, wd_bias=wd)
        ref = fused_mf_epoch_plain(*args, meta, **kw)
        out = fused_mf_epoch(*[a.clone() if torch.is_tensor(a) else a for a in args], meta,
                             **kw)
        torch.cuda.synchronize()
        label = (f'{loss_kind} adaptive={adaptive} K={K} B={B} D={D} F={F} wd={wd} '
                 f'dup={dup}')
        max_err = max(max_err, compare_epoch(label, out, ref))

    # the ML-10M shape: the engine's real first epoch, fresh Adam state
    model = ml10m_model(ml10m[0])
    specs = model.optimizer_specs()
    epoch_fn, _, S, _ = build_scan_epoch_fns(model, specs, [True] * len(specs),
                                             model.train_loader, shuffle=True)
    batches = epoch_fn.epoch_batches(7, 1)
    params = model.params
    U, D = params['user_embeddings'].shape
    I = params['item_embeddings'].shape[0]
    B, K = ML10M_BATCH, ML10M_DATA['num_negative_samples']
    kw = dict(K=K, adaptive=True, loss_kind='hinge')

    def state():
        return [params['user_embeddings'].clone(), params['item_embeddings'].clone(),
                params['item_biases'].clone(),
                *[torch.zeros_like(params[k]) for k in ('user_embeddings', 'user_embeddings',
                                                        'item_embeddings', 'item_embeddings')],
                torch.zeros((), dtype=torch.int32, device=DEVICE)]

    def epoch_args(start, stop):
        return [batches[k][start:stop] for k in ('users', 'pos_items', 'neg_items', 'mask')] \
            + [0.1, 0.01, None]

    shape = f'U={U} I={I} D={D} B={B} K={K}'
    ref = fused_mf_epoch_plain(*state(), *epoch_args(0, 3), **kw)
    out = fused_mf_epoch(*state(), *epoch_args(0, 3), **kw)
    torch.cuda.synchronize()
    max_err = max(max_err, compare_epoch(f'ML-10M shape, 3 steps, {shape}', out, ref,
                                         max_flipped=MAX_FLIPPED_FRACTION))
    # one full epoch, step by step: each step of the kernel starts from the
    # plain version's state before that step, so every step of the epoch is
    # held to the tolerance without the divergence of two trajectories
    # (a flipped hardest negative moves an item row that ~70 examples of the
    # next step score against, and at lr 0.1 the two runs part within a few
    # steps; measured below for the single-call epoch)
    worst = 0.0
    current = state()
    plain_losses = []
    for step in range(S):
        ref = fused_mf_epoch_plain(*current, *epoch_args(step, step + 1), **kw)
        out = fused_mf_epoch(*[t.clone() for t in current], *epoch_args(step, step + 1), **kw)
        torch.cuda.synchronize()
        worst = max(worst, compare_epoch(f'ML-10M shape, step {step}', out, ref,
                                         max_flipped=MAX_FLIPPED_FRACTION, quiet=True))
        plain_losses.append(float(ref[8][0]))
        current = list(ref[:8])
        del out
    max_err = max(max_err, worst)
    log(f'  ML-10M shape, one epoch ({S} steps) held step by step, {shape}: '
        f'max_abs_err={worst:.3g}')
    out = fused_mf_epoch(*state(), *epoch_args(0, S), **kw)
    torch.cuda.synchronize()
    kernel_losses = out[8].tolist()
    if not all(np.isfinite(kernel_losses)):
        raise AssertionError('ML-10M one-call epoch: non-finite losses')
    parted = max(abs(a - b) / abs(b) for a, b in zip(kernel_losses, plain_losses))
    log(f'  ML-10M shape, the same epoch as one call: per-step losses within '
        f'{parted:.3%} of the plain trajectory (first {kernel_losses[0]:.6f} vs '
        f'{plain_losses[0]:.6f}, last {kernel_losses[-1]:.6f} vs {plain_losses[-1]:.6f}); '
        f'user_emb max abs difference {float((out[0] - current[0]).abs().max()):.3g}')
    del out, current, ref

    tables = state()
    kernel_ms = cuda_median_ms(lambda: fused_mf_epoch(*tables, *epoch_args(0, S), **kw),
                               warmup=1, runs=5)
    plain_ms = cuda_median_ms(lambda: fused_mf_epoch_plain(*state(), *epoch_args(0, S), **kw),
                              warmup=0, runs=1)
    # least traffic per step: the dense update streams the tables, both
    # moments and the accumulator (read + write: 32 (U + I) D bytes), the
    # item bias and its gradient (16 I), and the step's ids and mask
    nbytes = S * (32.0 * (U + I) * D + 16.0 * I + 4.0 * B * (K + 3))
    ops = S * 6.0 * B * (K + 1) * D
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    log(f'  ML-10M epoch ({S} steps): kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} '
        f'bound_ms={bound_ms:.4f} (operations {ops_ms:.4f}, bytes {bytes_ms:.4f}); '
        f'library_ms=null: no single PyTorch call computes an epoch of sampled-negative '
        f'MF training with Adam')
    del tables, batches, epoch_fn, model
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return {
        'name': 'fused_mf_epoch',
        'route': 'cuda',
        'source': 'collie_tpu_torch/csrc/fused_mf_epoch.cu',
        'replaces': 'collie_tpu/ops/pallas/fused_mf_epoch.py:148',
        'launches': 0,
        'max_abs_err': max_err,
        'ms': kernel_ms,
        'plain_ms': plain_ms,
        'bound_ms': bound_ms,
        'bound_by': 'operations' if ops_ms >= bytes_ms else 'bytes',
        'library_ms': None,
        'checked': True,
    }


def phase_training(ml10m, record: dict):
    """The training path: the gate configuration for 10 epochs, then the
    ML-10M-scale configuration for 3, both through ``CollieTrainer``."""
    from collie_tpu_torch import (CollieTrainer, Interactions, InteractionsDataLoader,
                                  MatrixFactorizationModel, auc, evaluate_in_batches, mapk,
                                  mrr, stratified_split)
    from collie_tpu_torch.data.synthetic import generate_implicit_interactions
    from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch

    with open(os.path.join('benchmarks', 'gates.json')) as f:
        gates = {name: spec['gate'] for name, spec in json.load(f).items()}

    # (a) the quality-gate configuration
    train, test = stratified_split(generate_implicit_interactions(**GATE_DATA), test_p=0.2,
                                   seed=42, force_split=True)
    loader = InteractionsDataLoader(interactions=train, batch_size=1024, shuffle=True, seed=42)
    model = MatrixFactorizationModel(train=loader, embedding_dim=10, lr=1e-1, loss='adaptive',
                                     seed=42)
    fused_mf_epoch.launches = 0
    trainer = CollieTrainer(model, max_epochs=GATE_EPOCHS, verbosity=0, seed=42)
    trainer.fit(model)
    torch.cuda.synchronize()
    launches = fused_mf_epoch.launches
    epochs = trainer.num_epochs_completed
    if launches != epochs or epochs != GATE_EPOCHS:
        raise AssertionError(f'gate fit: {launches} kernel launches for {epochs} epochs')
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K,
                                              batch_size=256, verbose=False)
    log(f'gate config fit ({train.num_interactions} train interactions, {GATE_EPOCHS} '
        f'epochs): {trainer.last_fit_examples_per_sec:,.0f} examples/s; per epoch ms '
        f'(shuffle, sampler, kernel): '
        f'{[tuple(round(e[k], 3) for k in SPLIT) for e in trainer.epoch_log]}; '
        f'MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} AUC={auc_v:.5f} (gates {gates["mapk"]:.5f}, '
        f'{gates["mrr"]:.5f}, {gates["auc"]:.5f}); fused_mf_epoch launches {launches}')
    for name, value in (('mapk', map_k), ('mrr', mrr_v), ('auc', auc_v)):
        if not value > gates[name]:
            raise AssertionError(f'gate config: {name}={value} does not clear {gates[name]}')
    del model, trainer

    # (b) the ML-10M-scale configuration
    train, _, test = ml10m
    model = ml10m_model(train)
    torch.cuda.reset_peak_memory_stats()
    trainer = CollieTrainer(model, max_epochs=ML10M_EPOCHS, verbosity=0, seed=7)
    start = time.perf_counter()
    trainer.fit(model)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - start
    epochs += trainer.num_epochs_completed
    launches = fused_mf_epoch.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != epochs or trainer.num_epochs_completed != ML10M_EPOCHS:
        raise AssertionError(f'{launches} kernel launches for {epochs} epochs')
    log(f'ML-10M-scale fit ({train.num_interactions} train interactions, batch {ML10M_BATCH}, '
        f'{ML10M_EPOCHS} epochs): {fit_s:.2f}s incl. epoch-data build, '
        f'{trainer.last_fit_examples_per_sec:,.0f} examples/s, peak device memory '
        f'{peak_gb:.3f} GB')
    for e in trainer.epoch_log:
        host_ms = e['seconds'] * 1e3 - sum(e[k] for k in SPLIT)
        log(f'  epoch {e["epoch"]}: {e["seconds"] * 1e3:.3f} ms = shuffle {e["shuffle_ms"]:.3f} '
            f'+ sampler {e["sample_ms"]:.3f} + kernel {e["train_ms"]:.3f} + host {host_ms:.3f}')

    rng = np.random.default_rng(0)
    sample = np.sort(rng.choice(np.unique(test.mat.row), ML10M_EVAL_USERS, replace=False))
    keep = np.isin(test.mat.row, sample)
    sub = Interactions(users=test.mat.row[keep], items=test.mat.col[keep],
                       num_users=test.num_users, num_items=test.num_items,
                       allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                       seed=0)
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], sub, model, k=K,
                                              batch_size=512, verbose=False)
    untrained = MatrixFactorizationModel(train=model.train_loader, embedding_dim=ML10M_DIM,
                                         lr=1e-1, loss='adaptive', seed=99)
    untrained_map = evaluate_in_batches([mapk], sub, untrained, k=K, batch_size=512,
                                        verbose=False)
    torch.cuda.synchronize()
    log(f'  {ML10M_EVAL_USERS} test users: MAP@{K}={map_k:.5f} MRR={mrr_v:.5f} AUC={auc_v:.5f} '
        f'(untrained MAP@{K}={untrained_map:.5f}); fused_mf_epoch launches over both fits '
        f'{launches} for {epochs} epochs')
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (map_k, mrr_v, auc_v)):
        raise AssertionError(f'metrics out of range: {map_k}, {mrr_v}, {auc_v}')
    if not map_k > untrained_map:
        raise AssertionError(f'trained MAP@{K} {map_k} does not beat untrained {untrained_map}')
    record['launches'] = launches


def serving_data(seed: int):
    """Seeded implicit interactions at the serving scale, split per user."""
    from collie_tpu_torch.data import Interactions, stratified_split

    rng = np.random.default_rng(seed)
    users = rng.integers(0, NUM_USERS, NUM_INTERACTIONS)
    # skewed item popularity: low ranks are popular, ranks map to random ids
    ranks = np.floor(NUM_ITEMS * rng.random(NUM_INTERACTIONS) ** 3).astype(np.int64)
    items = rng.permutation(NUM_ITEMS)[ranks]
    inter = Interactions(users=users, items=items, num_users=NUM_USERS,
                         num_items=NUM_ITEMS, allow_missing_ids=True,
                         num_negative_samples=10, seed=seed)
    train, test = stratified_split(inter, test_p=0.2, seed=seed, force_split=True)
    eval_users = np.sort(rng.choice(np.unique(test.mat.row), EVAL_USERS, replace=False))
    keep = np.isin(test.mat.row, eval_users)
    test_eval = Interactions(users=test.mat.row[keep], items=test.mat.col[keep],
                             num_users=NUM_USERS, num_items=NUM_ITEMS,
                             allow_missing_ids=True,
                             check_num_negative_samples_is_valid=False, seed=seed)
    return train, test_eval


def dense_reference(model, users: np.ndarray, seen_csr=None, k: int = K):
    """Dense stable top-(k+1) on the card: the whole catalog scored with one
    matmul, seen items masked by CSR row scatter."""
    from collie_tpu_torch.ops.kernels.retrieval_kernel import NEG_INF, stable_topk

    with torch.no_grad():
        scores = model.score_all_items(model.params, model._ids(users))
        if seen_csr is not None:
            rows = seen_csr[users]
            r = np.repeat(np.arange(len(users)), np.diff(rows.indptr))
            scores[torch.as_tensor(r, device=model.device),
                   torch.as_tensor(rows.indices.astype(np.int64), device=model.device)] = NEG_INF
        ref_scores, ref_ids = stable_topk(scores, k + 1)
    return ref_ids[:, :k], ref_scores[:, :k], ref_scores[:, k]


def phase_serving(seed: int, record: dict):
    from collie_tpu_torch import MatrixFactorizationModel, auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.ops import metrics as metrics_lib
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve
    from collie_tpu_torch.retrieval import recommend

    start = time.perf_counter()
    train, test = serving_data(seed)
    log(f'serving data: {train.num_interactions} train / {test.num_interactions} test '
        f'interactions, {NUM_USERS} users x {NUM_ITEMS} items '
        f'({time.perf_counter() - start:.1f}s)')

    built = MatrixFactorizationModel(train=train, embedding_dim=EMBEDDING_DIM, seed=seed)
    path = os.path.join('data', f'chip_smoke_mf_{os.getpid()}.npz')
    try:
        built.save_model(path)
        model = MatrixFactorizationModel(train=train, load_model_path=path)
    finally:
        if os.path.exists(path):
            os.unlink(path)
    for name, value in built.params.items():
        if not torch.equal(value, model.params[name]):
            raise AssertionError(f'npz round trip changed {name}')
    if model.device.type != 'cuda':
        raise AssertionError(f'model loaded on {model.device}')
    del built
    torch.cuda.synchronize()
    log(f'model: MF embedding_dim={EMBEDDING_DIM} built, saved to npz and reloaded '
        f'on {model.device}; params {sorted(model.state_dict())}')

    rng = np.random.default_rng(seed + 1)
    seen_csr = train.mat.tocsr()
    torch.cuda.reset_peak_memory_stats()
    mf_topk_retrieve.launches = 0
    timings = {False: [], True: []}
    requests = [(False, rng.choice(NUM_USERS, REQUEST_USERS, replace=False)) for _ in range(4)]
    requests += [(True, rng.choice(NUM_USERS, REQUEST_USERS, replace=False)) for _ in range(2)]
    answers = []
    for filter_seen, users in requests:
        t0 = time.perf_counter()
        ids, scores = recommend(model, users, k=K, filter_seen=filter_seen)
        torch.cuda.synchronize()
        timings[filter_seen].append((time.perf_counter() - t0) * 1e3)
        answers.append((filter_seen, users, ids, scores))
    launches = mf_topk_retrieve.launches
    mf_topk_retrieve.launches = 0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != 4:
        raise AssertionError(f'kernel launches during serving: {launches}, expected 4')
    record['launches'] = launches

    for n, (filter_seen, users, ids, scores) in enumerate(answers):
        ref_ids, ref_scores, ref_next = dense_reference(
            model, users, seen_csr if filter_seen else None)
        check_topk(f'request {n} filter_seen={filter_seen}', torch.as_tensor(ids),
                   torch.as_tensor(scores), ref_ids, ref_scores, ref_next)
        if filter_seen:
            for row, u in zip(ids, users):
                seen = seen_csr.indices[seen_csr.indptr[u]:seen_csr.indptr[u + 1]]
                if np.isin(row, seen).any():
                    raise AssertionError(f'user {u}: a seen item was recommended')
        del ref_ids, ref_scores, ref_next
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f'recommend ms per request of {REQUEST_USERS} users: kernel path (filter_seen=False) '
        f'{[round(t, 3) for t in timings[False]]}, blockwise path (filter_seen=True) '
        f'{[round(t, 3) for t in timings[True]]}; topk_tile launches {launches}; '
        f'peak device memory {peak_gb:.3f} GB')

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    map_k, mrr_v, auc_v = evaluate_in_batches([mapk, mrr, auc], test, model, k=K)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    if not all(np.isfinite(v) and 0.0 <= v <= 1.0 for v in (map_k, mrr_v, auc_v)):
        raise AssertionError(f'metrics out of range: {map_k}, {mrr_v}, {auc_v}')
    # the rank-count metrics against the dense-relevance ones on 64 users
    users = np.unique(test.mat.row)[:64]
    targets = test.mat.tocsr()
    with torch.no_grad():
        preds = model.score_all_items(model.params, model._ids(users))
        pos, mask = metrics_lib.padded_positives(targets, users)
        fused = metrics_lib.metrics_from_positive_ranks(
            preds, torch.as_tensor(pos, device=model.device),
            torch.as_tensor(mask, device=model.device),
            K).mean(dim=1).tolist()
    dense = [mapk(targets, users, preds, K), mrr(targets, users, preds), auc(targets, users, preds)]
    if not np.allclose(fused, dense, rtol=1e-5, atol=1e-6):
        raise AssertionError(f'rank-count metrics {fused} vs dense {dense}')
    torch.cuda.synchronize()
    log(f'evaluate_in_batches on {len(np.unique(test.mat.row))} test users: MAP@{K}={map_k:.6f} '
        f'MRR={mrr_v:.6f} AUC={auc_v:.6f} in {eval_s:.2f}s, peak device memory '
        f'{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; rank counts equal dense '
        f'metrics on 64 users ({fused} vs {dense})')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)
    t0 = time.perf_counter()

    smi = phase_device()
    phase_build()
    topk = phase_kernels()
    ml10m = ml10m_data()
    fused = phase_kernel_fused_epoch(ml10m)
    phase_serving(args.seed, topk)
    phase_training(ml10m, fused)

    log(f'total_seconds={time.perf_counter() - t0:.1f}')
    print(json.dumps({'kernels': [topk, fused]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
