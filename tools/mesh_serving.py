"""Item-sharded serving across the cards of one host: ``chip_smoke.py``
phase 4's configuration through ``recommend(..., mesh=)`` and
``evaluate_in_batches(..., mesh=)`` on ``make_mesh(data=1, model=N)``.

One process a card (``torch.multiprocessing.spawn``, NCCL, a ``file://``
rendezvous in a temporary directory).  Every rank builds the same seeded
data and MF (2,000,000 items, D = 64, 100,000 users) and, after one
untimed request of each kind on each path, serves the same requests of 256
users (``REQUESTS``: ``filter_seen=False``, each rank's shard through the
top-k kernel, then ``filter_seen=True``), each through the mesh and then on
the rank's own card, and evaluates the 2,048 test users both ways; each
answer must equal the single-card call (ids exactly, scores within
``chip_smoke.RTOL`` / ``ATOL``, metrics within rtol 1e-5), every rank must
return the same answer, and each rank's top-k kernel must launch once a
``filter_seen=False`` request.  Prints each request's ms through the mesh
and on one card (host clock around a call ending in a synchronize), the
card's name and power limit, and last one JSON object.

    python3 tools/mesh_serving.py [--cards N] [--seed 0]

``--device cpu`` runs the same program on gloo at toy sizes (``--users``,
``--items``, ``--interactions``) as a rehearsal.
"""
import argparse
import json
import os
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

REQUESTS = (False, False, False, True, True, True)


def _timed(call, sync):
    sync()
    t0 = time.perf_counter()
    out = call()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def _serve(rank, world, init_method, args, out_dir):
    import torch.distributed as dist

    from collie_tpu_torch import MatrixFactorizationModel, auc, evaluate_in_batches, mapk, mrr
    from collie_tpu_torch.ops.kernels.retrieval_kernel import mf_topk_retrieve
    from collie_tpu_torch.parallel import make_mesh
    from collie_tpu_torch.retrieval import recommend

    cuda = args.device == 'cuda'
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group('nccl' if cuda else 'gloo', init_method=init_method,
                            world_size=world, rank=rank, timeout=timedelta(seconds=300))
    try:
        mesh = make_mesh(data=1, model=world, devices=args.device)
        cs.NUM_USERS, cs.NUM_ITEMS, cs.NUM_INTERACTIONS = args.users, args.items, \
            args.interactions
        train, test = cs.serving_data(args.seed)
        model = MatrixFactorizationModel(train=train, embedding_dim=cs.EMBEDDING_DIM,
                                         seed=args.seed,
                                         map_location=f'cuda:{rank}' if cuda else 'cpu')
        rng = np.random.default_rng(args.seed + 1)
        warm = rng.choice(args.users, cs.REQUEST_USERS, replace=False)
        for filter_seen in (False, True):   # communicators, handles, allocator
            recommend(model, warm, k=cs.K, filter_seen=filter_seen, mesh=mesh)
            recommend(model, warm, k=cs.K, filter_seen=filter_seen)
        requests = [(fs, rng.choice(args.users, cs.REQUEST_USERS, replace=False))
                    for fs in REQUESTS]
        out = {'mesh_ms': [], 'single_ms': [], 'launches': [], 'max_abs_err': 0.0,
               'answers': []}
        for filter_seen, users in requests:   # mesh, then one card, request by request
            mf_topk_retrieve.launches = 0
            (ids, scores), ms = _timed(lambda: recommend(
                model, users, k=cs.K, filter_seen=filter_seen, mesh=mesh), sync)
            out['mesh_ms'].append(ms)
            out['launches'].append(mf_topk_retrieve.launches)
            (ref_ids, ref_scores), ms = _timed(lambda: recommend(
                model, users, k=cs.K, filter_seen=filter_seen), sync)
            out['single_ms'].append(ms)
            if not np.array_equal(ids, ref_ids):
                raise AssertionError(f'rank {rank} filter_seen={filter_seen}: ids differ in '
                                     f'{int((ids != ref_ids).any(axis=1).sum())} rows')
            if not np.allclose(scores, ref_scores, rtol=cs.RTOL, atol=cs.ATOL):
                raise AssertionError(f'rank {rank} filter_seen={filter_seen}: scores differ')
            out['max_abs_err'] = max(out['max_abs_err'],
                                     float(np.abs(scores - ref_scores).max()))
            out['answers'].append((ids.tolist(), scores.tolist()))
        metrics = [mapk, mrr, auc]
        out['metrics'], ms = _timed(lambda: evaluate_in_batches(
            metrics, test, model, k=cs.K, mesh=mesh, verbose=False), sync)
        out['mesh_eval_s'] = ms / 1e3
    finally:
        dist.destroy_process_group()
    single, ms = _timed(lambda: evaluate_in_batches(metrics, test, model, k=cs.K,
                                                    verbose=False), sync)
    out['single_eval_s'] = ms / 1e3
    if not np.allclose(out['metrics'], single, rtol=1e-5, atol=1e-7):
        raise AssertionError(f'rank {rank}: mesh metrics {out["metrics"]} vs {single}')
    expected = [0 if fs else (1 if cuda else 0) for fs in REQUESTS]
    if out['launches'] != expected:
        raise AssertionError(f'rank {rank}: top-k launches {out["launches"]}, expected '
                             f'{expected}')
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cards', type=int, default=None,
                        help='processes (one a card); default: every card')
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--users', type=int, default=cs.NUM_USERS)
    parser.add_argument('--items', type=int, default=cs.NUM_ITEMS)
    parser.add_argument('--interactions', type=int, default=cs.NUM_INTERACTIONS)
    args = parser.parse_args(argv)
    if args.device == 'cuda':
        smi = cs.phase_device()
        cs.phase_build()
        world = args.cards or torch.cuda.device_count()
    else:
        smi = 'cpu (gloo rehearsal)'
        world = args.cards or 4
    with tempfile.TemporaryDirectory() as directory:
        torch.multiprocessing.spawn(
            _serve, args=(world, f'file://{directory}/rendezvous', args, directory),
            nprocs=world)
        ranks = []
        for rank in range(world):
            with open(os.path.join(directory, f'rank{rank}.json')) as f:
                ranks.append(json.load(f))
    for other in ranks[1:]:
        if other['answers'] != ranks[0]['answers'] or other['metrics'] != ranks[0]['metrics']:
            raise AssertionError('ranks returned different answers')
    summary = {'world': world, 'items': args.items, 'requests': list(REQUESTS),
               'mesh_ms': [r['mesh_ms'] for r in ranks],
               'single_ms': [r['single_ms'] for r in ranks],
               'launches': [r['launches'] for r in ranks],
               'max_abs_err': max(r['max_abs_err'] for r in ranks),
               'metrics': ranks[0]['metrics'],
               'mesh_eval_s': [r['mesh_eval_s'] for r in ranks],
               'single_eval_s': [r['single_eval_s'] for r in ranks]}
    print(f'mesh (1, {world}): ids equal the single-device calls on every rank; rank 0 ms '
          f'mesh {[round(t, 3) for t in ranks[0]["mesh_ms"]]} vs one card '
          f'{[round(t, 3) for t in ranks[0]["single_ms"]]}', flush=True)
    print(smi)
    print(json.dumps({'mesh_serving': summary}))


if __name__ == '__main__':
    main()
