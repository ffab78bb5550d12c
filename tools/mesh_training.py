"""Mesh training across the cards of one host: ``chip_smoke.py`` phase 14's
ML-10M-scale MF configuration (``benchmarks/bench_ml10m_scale.py:34-72``:
72,000 x 10,000, D = 32, B = 65,536, adaptive hinge, K = 10, seed 7)
through ``CollieTrainer(mesh=)`` on ``make_mesh(data, model)`` for each
mesh shape of the world.

One process a card (``torch.multiprocessing.spawn``, NCCL, a ``file://``
rendezvous in a temporary directory).  Every rank builds the same seeded
data.  Each rank first fits the configuration on its own card without a
mesh (the generic epoch, ``COLLIE_TPU_FUSED_EPOCH=0``, the path a mesh
fit takes), then, for each shape in ``--shapes``, the whole fit through
the mesh from the same seed.  Per fit: examples/s (host clock over the
fit, as ``CollieTrainer.last_fit_examples_per_sec``), its epochs (equal to
the single card's), its train losses (the same on every rank) and how far
its losses and params end from the single card's (printed: at lr 0.1 a
hardest negative that two summation orders pick differently cascades over
whole fits); then ``chip_smoke.hold_mesh_steps``: mesh steps of the fitted
model held to single-card steps from one state, the first one's
collectives counted (calls and elements of each op, mesh axis and dtype).
Prints a line a fit, the card's name and power limit, one JSON object, and
fails after them if a fit broke a rule.

    python3 tools/mesh_training.py [--cards N] [--shapes 4x1,2x2,1x4] [--epochs 3]

``--device cpu`` runs the same program on gloo at toy sizes (``--users``,
``--items``, ``--interactions``, ``--batch``) as a rehearsal.
"""
import argparse
import json
import os
import sys
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _fit(train, mesh, epochs, device):
    """A whole fit of the configuration: the trainer, the model and the
    epochs' train losses."""
    from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, MatrixFactorizationModel

    loader = InteractionsDataLoader(interactions=train, batch_size=cs.ML10M_BATCH, shuffle=True,
                                    seed=7)
    model = MatrixFactorizationModel(train=loader, embedding_dim=cs.ML10M_DIM, lr=1e-1,
                                     loss='adaptive', seed=7, map_location=device)
    losses = cs._LossLog()
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=7, mesh=mesh,
                            logger=losses, enable_model_summary=False)
    trainer.fit(model)
    return trainer, model, [float(x) for x in losses.losses]


def _train(rank, world, init_method, args, out_dir):
    import torch.distributed as dist

    from collie_tpu_torch.parallel import make_mesh

    cuda = args.device == 'cuda'
    device = f'cuda:{rank}' if cuda else 'cpu'
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cs.ML10M_DATA = dict(cs.ML10M_DATA, num_users=args.users, num_items=args.items,
                         num_interactions=args.interactions)
    cs.ML10M_BATCH = args.batch
    train, _, _ = cs.ml10m_data()['implicit']
    out = {'fits': {}}
    os.environ['COLLIE_TPU_FUSED_EPOCH'] = '0'
    trainer, model, losses = _fit(train, None, args.epochs, device)
    sync()
    ref = {k: v.detach() for k, v in model.params.items()}
    out['single'] = {'examples_per_s': trainer.last_fit_examples_per_sec, 'losses': losses,
                     'epochs': trainer.num_epochs_completed}
    dist.init_process_group('nccl' if cuda else 'gloo', init_method=init_method,
                            world_size=world, rank=rank, timeout=timedelta(seconds=600))
    try:
        for shape in args.shapes:
            mesh = make_mesh(data=shape[0], model=shape[1], devices=args.device)
            _fit(train, mesh, 1, device)            # communicators, allocator: not timed
            trainer, model, losses = _fit(train, mesh, args.epochs, device)
            sync()
            gap = cs._params_gap(model.whole_params(), ref)
            local = {k: list(v.shape) for k, v in model.params.items()}
            try:
                held = cs.hold_mesh_steps(model, mesh, args.epochs + 1, sync)
            except AssertionError as err:          # reported, then the run fails
                held = {'error': str(err)}
            out['fits'][f'{shape[0]}x{shape[1]}'] = {
                'examples_per_s': trainer.last_fit_examples_per_sec, 'losses': losses,
                'epochs': trainer.num_epochs_completed, 'params_gap': gap, 'local': local,
                'held': held}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f'rank{rank}.json'), 'w') as f:
        json.dump(out, f)


def _shape(text):
    data, model = text.split('x')
    return int(data), int(model)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--cards', type=int, default=None,
                        help='processes (one a card); default: every card')
    parser.add_argument('--shapes', default=None,
                        help='mesh shapes, e.g. 4x1,2x2,1x4 (default: those of the world)')
    parser.add_argument('--epochs', type=int, default=3)
    parser.add_argument('--device', default='cuda', choices=('cuda', 'cpu'))
    parser.add_argument('--users', type=int, default=cs.ML10M_DATA['num_users'])
    parser.add_argument('--items', type=int, default=cs.ML10M_DATA['num_items'])
    parser.add_argument('--interactions', type=int,
                        default=cs.ML10M_DATA['num_interactions'])
    parser.add_argument('--batch', type=int, default=cs.ML10M_BATCH)
    args = parser.parse_args(argv)
    if args.device == 'cuda':
        smi = cs.phase_device()
        cs.phase_build()
        world = args.cards or torch.cuda.device_count()
    else:
        smi = 'cpu (gloo rehearsal)'
        world = args.cards or 4
    if args.shapes:
        args.shapes = [_shape(s) for s in args.shapes.split(',')]
    else:
        args.shapes = [(world // m, m) for m in (1, 2, 4) if world % m == 0 and m <= world]
    if any(d * m != world for d, m in args.shapes):
        raise ValueError(f'every shape must hold {world} processes: {args.shapes}')
    with tempfile.TemporaryDirectory() as directory:
        torch.multiprocessing.spawn(
            _train, args=(world, f'file://{directory}/rendezvous', args, directory),
            nprocs=world)
        ranks = []
        for rank in range(world):
            with open(os.path.join(directory, f'rank{rank}.json')) as f:
                ranks.append(json.load(f))
    single = ranks[0]['single']
    faults = []
    for name, fit in ranks[0]['fits'].items():
        if any(other['fits'][name]['losses'] != fit['losses'] for other in ranks[1:]):
            faults.append(f'{name}: ranks report different losses')
        if fit['epochs'] != single['epochs']:
            faults.append(f'{name}: {fit["epochs"]} epochs, one card {single["epochs"]}')
        faults += [f'{name} rank {r}: {other["fits"][name]["held"]["error"]}'
                   for r, other in enumerate(ranks) if 'error' in other['fits'][name]['held']]
        a, b = np.asarray(fit['losses']), np.asarray(single['losses'])
        fit['losses_parted'] = float(np.max(np.abs(a - b) / np.abs(b)))
        held = fit['held']
        steps = ('held steps apart' if 'error' in held else
                 f'{cs.MESH_TRAIN_HELD_STEPS} steps held to one card\'s from one state (losses '
                 f'within {held["loss"]:.3g}, table elements beyond the tolerance '
                 f'{held["share"]:.3g}); one step {held["step_ms"]:.2f} ms on rank 0, '
                 'collectives ' + '; '.join(f'{k}: {c} calls, {n:,} elements'
                                            for k, (c, n) in sorted(held['collectives'].items())))
        print(f'mesh {name}: {fit["examples_per_s"]:,.0f} examples/s (one card '
              f'{single["examples_per_s"]:,.0f}); whole-fit train losses within '
              f'{fit["losses_parted"]:.3g} and largest param difference '
              f'{fit["params_gap"]:.3g} of max|ref| of one card\'s; {steps}', flush=True)
    print(smi)
    print(json.dumps({'mesh_training': {
        'world': world, 'epochs': args.epochs, 'single': single, 'fits': ranks[0]['fits'],
        'single_examples_per_s_by_rank': [r['single']['examples_per_s'] for r in ranks],
        'examples_per_s_by_rank': {name: [r['fits'][name]['examples_per_s'] for r in ranks]
                                   for name in ranks[0]['fits']}}}))
    if faults:
        raise AssertionError('; '.join(faults))


if __name__ == '__main__':
    main()
