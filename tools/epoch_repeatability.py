"""How far two launches of one ML-10M-scale training epoch drift apart, on a
CUDA card.

The epoch kernels sum duplicate rows with atomics in a run-dependent order,
and under the adaptive hinge loss a rounding difference can change which
negative is the hardest, and so an update.  This script fits the
ML-10M-scale configuration of ``chip_smoke.py`` (lr 0.1 and the default
``ReduceLROnPlateau(patience=1)``) for ``--epochs`` epochs through the
trainer, keeping the state after each epoch; then, for each epoch E of
``--hold``, it launches ``fused_mf_epoch`` ``--repeats`` times on E's batches
from the state after epoch E - 1 and holds each launch against the first:
the relative difference of each step's loss, and the share of each table's
elements outside ``chip_smoke.compare_epoch``'s tolerance.

    python3 tools/epoch_repeatability.py [--epochs 5] [--hold 3 4] [--repeats 3]

Prints one line per held epoch and launch, the card's name and power limit,
and last one JSON object with every number.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from collie_tpu_torch.ops.kernels.fused_mf_epoch import fused_mf_epoch  # noqa: E402
from collie_tpu_torch.training.scan_engine import build_scan_epoch_fns  # noqa: E402

TABLES = ('user_embeddings', 'item_embeddings', 'item_biases')


def launch(state, batches, k):
    """One ``fused_mf_epoch`` launch on copies of a captured state; returns
    ``(tables, per-step losses)``."""
    params = {name: state['params'][name].clone() for name in TABLES}
    emb, bias = state['opt_states']
    out = fused_mf_epoch(
        params['user_embeddings'], params['item_embeddings'], params['item_biases'],
        emb.mu['user_embeddings'].clone(), emb.nu['user_embeddings'].clone(),
        emb.mu['item_embeddings'].clone(), emb.nu['item_embeddings'].clone(),
        emb.adam_count.clone(), batches['users'], batches['pos_items'], batches['neg_items'],
        batches['mask'], emb.learning_rate, bias.learning_rate, None, K=k, adaptive=True,
        loss_kind='hinge')
    torch.cuda.synchronize()
    return dict(zip(TABLES, out[:3])), out[-1]


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--epochs', type=int, default=5)
    parser.add_argument('--hold', type=int, nargs='+', default=[3, 4])
    parser.add_argument('--repeats', type=int, default=3)
    args = parser.parse_args(argv)

    smi = cs.phase_device()
    cs.phase_build()
    train = cs.ml10m_data()['implicit'][0]
    model = cs.ml10m_model(train)
    with tempfile.TemporaryDirectory() as directory:
        _, live = cs._checkpointed_fit(model, args.epochs, directory)
    specs = model.optimizer_specs()
    epoch_fn = build_scan_epoch_fns(model, specs, [True] * len(specs), model.train_loader,
                                    shuffle=True)[0]
    k = cs.ML10M_DATA['num_negative_samples']
    result = {'loss_by_epoch': [live[e]['loss'] for e in sorted(live)],
              'lr_after_epoch': [live[e]['opt_states'][0].learning_rate for e in sorted(live)],
              'held': {}}
    for epoch in args.hold:
        batches = epoch_fn.epoch_batches(7, epoch)
        start = live[epoch - 1]
        runs = [launch(start, batches, k) for _ in range(args.repeats)]
        ref_tables, ref_losses = runs[0]
        held = []
        for r, (tables, losses) in enumerate(runs[1:], start=1):
            rel = ((losses - ref_losses).abs() / ref_losses.abs()).tolist()
            outside = {}
            for name in TABLES:
                a, b = tables[name], ref_tables[name]
                tol = cs.EPOCH_RTOL * b.abs() + cs.EPOCH_ATOL_SCALE * b.abs().max()
                outside[name] = float(((a - b).abs() > tol).float().mean())
            held.append({'step_loss_rel_diff': rel, 'share_outside_tolerance': outside})
            cs.log(f'epoch {epoch} (lr {start["opt_states"][0].learning_rate:.3g}), launch {r} '
                   f'vs launch 0: step-loss relative difference max over steps 1-10 '
                   f'{max(rel[:10]):.3g}, over the last 10 {max(rel[-10:]):.3g}; share outside '
                   f'the tolerance {outside} ({smi})')
        result['held'][str(epoch)] = held
    print(smi)
    print(json.dumps({'epoch_repeatability': result}))


if __name__ == '__main__':
    main()
