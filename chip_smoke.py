"""Drive collie_tpu_torch's serving path on one CUDA card and check it.

Run from the root of a checkout on a machine with an NVIDIA card (written
for the H100):

    python3 chip_smoke.py [--seed N]

Phases, each ending in ``torch.cuda.synchronize()``; any failure exits
non-zero before the result line:

1. device: card name and power limit, TF32 switched off for matmuls and cuDNN;
2. build: every CUDA kernel of the path, compiled from ``collie_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   the edge shapes of the JAX package's own tests, a tie case, and the
   serving shape, with times for the kernel, the plain version and one
   library call that computes the same function;
4. serving: an MF model at the repo's serving scale (2,000,000 items,
   ``embedding_dim=64``, random weights from the seed) is built from seeded
   interactions, saved to npz and loaded back, then answers four
   ``recommend`` requests of 256 users without seen filtering (the kernel
   path, shown by the launch counter) and two with it (the blockwise path),
   each checked against a dense stable top-k, and runs
   ``evaluate_in_batches`` on 2,048 test users;
5. the kernels line (one JSON object), the card's name and power limit, and
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

NUM_USERS = 100_000
NUM_ITEMS = 2_000_000            # benchmarks/retrieval_results.json catalog_2000000
EMBEDDING_DIM = 64
NUM_INTERACTIONS = 5_000_000
REQUEST_USERS = 256
EVAL_USERS = 2_048
K = 10


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
    record = phase_kernels()
    phase_serving(args.seed, record)

    log(f'total_seconds={time.perf_counter() - t0:.1f}')
    print(json.dumps({'kernels': [record]}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {'platform': 'gpu',
                                             'kind': torch.cuda.get_device_name(0),
                                             'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
