"""The port's staged ``HybridModel`` training against the benchmark's plain
reference (``portbench/reference/hybrid_epochs.py``), on the CPU at a small
size.

A ``HybridModel(embedding_dim=8, combined_layers_dims=[16, 8])`` with 12
item metadata columns and an adaptive hinge over 4 negatives, on 60 users x
40 items, trains one epoch of 64-row batches in each of its three stages
through ``CollieTrainer.fit`` (``advance_stage`` and ``max_epochs`` raised
between the fits, as collie's tutorial does): the generic epoch, the
sparse-hardest selection, the stage masks.  Its weights are seeded random
ones (Normal(0, 0.3) on every leaf), so the combined MLP is awake from the
first step.  Every ``scan_engine.train_step`` call is recorded: its state
before and after, the stage's active optimizers' moments and its rows; the
reference takes each step again from the program's own state.  Nothing
here imports JAX's package; the reference is held to import none of the
packages.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from collie_tpu_torch import CollieTrainer, HybridModel, InteractionsDataLoader
from collie_tpu_torch.data import Interactions
from collie_tpu_torch.training import scan_engine

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.reference import hybrid_epochs  # noqa: E402

U, I, F, D, DIMS, K, B, SEED = 60, 40, 12, 8, [16, 8], 4, 64, 11
RATES = {'lr': 0.1, 'bias_lr': 1e-2, 'metadata_only_stage_lr': 1e-3, 'all_stage_lr': 1e-4}
STAGES = ('matrix_factorization', 'metadata_only', 'all')

#: the loss's relative gap: the same float32 arithmetic on the same rows
LOSS_RTOL = 1e-6
#: Adam's first moments (norm of the difference over the leaf's norm): one
#: step from the same state sums the tables' gradients in another order and
#: rounds them apart at ~1e-7
MOMENT_TOL = 1e-6
#: every leaf's change: a parameter near 0.3 has a float32 spacing of ~3e-8,
#: so a change of 1e-4 reads to ~3e-4 of itself whenever one rounding of the
#: update falls on the other side; a frozen leaf must not move at all
DELTA_TOL = 1e-3


@pytest.fixture(scope='module')
def fitted():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # several threads scatter-add in a run-dependent order
    try:
        rng = np.random.default_rng(5)
        keys = np.unique(rng.integers(0, U * I, 900))
        users, items = keys // I, keys % I
        metadata = rng.random((I, F)).astype(np.float32)
        inter = Interactions(users=users, items=items, num_users=U, num_items=I,
                             num_negative_samples=K, allow_missing_ids=True, seed=SEED)
        loader = InteractionsDataLoader(interactions=inter, batch_size=B, shuffle=True,
                                        seed=SEED)
        model = HybridModel(train=loader, item_metadata=metadata, embedding_dim=D,
                            combined_layers_dims=DIMS, loss='adaptive', seed=3,
                            map_location='cpu', **RATES)
        generator = torch.Generator().manual_seed(7)
        model.load_params({k: 0.3 * torch.randn(v.shape, generator=generator)
                           for k, v in model.params.items()})
        steps, fits = [], []
        real = scan_engine.train_step

        def moments(states, active):
            live = [s for s, on in zip(states, active) if on and s.mu]
            assert len(live) == 1
            return {'mu': {k: v.clone() for k, v in live[0].mu.items()},
                    'nu': {k: v.clone() for k, v in live[0].nu.items()},
                    't': int(live[0].adam_count)}

        def recording(model, specs, active, params, opt_states, batch, generator=None,
                      fused_tables=False, mesh=None, loss_scale=None):
            before = {'params': {k: v.detach().clone() for k, v in params.items()},
                      **moments(opt_states, active)}
            out = real(model, specs, active, params, opt_states, batch, generator,
                       fused_tables, mesh, loss_scale)
            steps.append({'stage': model.current_stage, 'before': before,
                          'batch': {k: v.clone() for k, v in batch.items()},
                          'params': {k: v.detach().clone() for k, v in out[0].items()},
                          'mu': moments(out[1], active)['mu'], 'loss': float(out[2]),
                          'fused_tables': fused_tables})
            return out

        scan_engine.train_step = recording
        try:
            trainer = CollieTrainer(model, max_epochs=0, seed=SEED, verbosity=0, logger=False,
                                    enable_model_summary=False)
            for n, stage in enumerate(STAGES):
                if n:
                    model.advance_stage()
                trainer.max_epochs += 1
                before = {k: v.detach().clone() for k, v in model.params.items()}
                trainer.fit(model)
                fits.append({'stage': stage, 'before': before,
                             'after': {k: v.detach().clone() for k, v in model.params.items()}})
        finally:
            scan_engine.train_step = real
        yield {'model': model, 'steps': steps, 'fits': fits,
               'metadata': torch.from_numpy(metadata)}
    finally:
        torch.set_num_threads(threads)


def test_each_stage_fits_one_epoch_on_the_generic_epoch_and_the_sparse_selection(fitted):
    model, steps = fitted['model'], fitted['steps']
    assert model.selection_route(K) == 'sparse'
    per_stage = [sum(s['stage'] == stage for s in steps) for stage in STAGES]
    assert per_stage[0] > 1 and per_stage == [per_stage[0]] * 3
    assert not any(s['fused_tables'] for s in steps)
    assert [f['stage'] for f in fitted['fits']] == list(STAGES)


def test_each_step_matches_the_reference_from_the_programs_own_state(fitted):
    worst = {}
    for s in fitted['steps']:
        ref = hybrid_epochs.step(s['before'], s['batch'], stage=s['stage'],
                                 metadata=fitted['metadata'], rates=RATES)
        found = hybrid_epochs.step_numbers(s['before']['params'], ref, s)
        for k, v in found.items():
            worst[k] = max(worst.get(k, 0.0), v)
    assert worst['step_loss_gap'] <= LOSS_RTOL, worst
    assert worst['step_grad_err'] < MOMENT_TOL, worst
    assert worst['step_delta_err'] < DELTA_TOL, worst


def test_the_frozen_leaves_keep_their_bits_through_each_stage(fitted):
    moved = {}
    for fit in fitted['fits']:
        adam, sgd = hybrid_epochs.trained_leaves(fit['stage'], fit['before'])
        frozen = [k for k in fit['before'] if k not in adam + sgd]
        assert all(torch.equal(fit['before'][k], fit['after'][k]) for k in frozen), fit['stage']
        moved[fit['stage']] = [k for k in adam + sgd
                               if not torch.equal(fit['before'][k], fit['after'][k])]
    assert set(moved['matrix_factorization']) == {'user_embeddings', 'item_embeddings',
                                                  'item_biases'}
    assert 'combined_layer_0_weight' in moved['metadata_only']
    assert {'user_embeddings', 'combined_layer_0_weight'} <= set(moved['all'])


def test_a_lower_precision_half_the_rows_or_a_stage_leak_fails_the_step_check(fitted):
    """bfloat16, a half batch and the tables trained in ``metadata_only``
    in the program's place read far above the tolerances (TF32 is the CPU's
    float32 and is checked on the card)."""
    worst = {}
    for s in fitted['steps']:
        if s['stage'] != 'metadata_only':
            continue
        ref = hybrid_epochs.step(s['before'], s['batch'], stage=s['stage'],
                                 metadata=fitted['metadata'], rates=RATES)
        for name, kwargs in (('bf16', {'dtype': torch.bfloat16}), ('half', {'drop_half': True}),
                             ('leak', {'leak': True})):
            got = hybrid_epochs.step(s['before'], s['batch'], stage=s['stage'],
                                     metadata=fitted['metadata'], rates=RATES, **kwargs)
            numbers = hybrid_epochs.step_numbers(s['before']['params'], ref, got)
            worst[name] = max(worst.get(name, 0.0), numbers['step_delta_err'])
    assert min(worst.values()) > 100 * DELTA_TOL, worst


@pytest.mark.parametrize('stage', STAGES[:2])
def test_pairwise_scores_equal_the_tiled_score_and_the_reference(fitted, stage):
    model = fitted['model']
    was = model.current_stage
    model.set_stage(stage)
    try:
        g = torch.Generator().manual_seed(1)
        users = torch.randint(0, U, (B,), generator=g)
        items = torch.randint(0, I, (5, B), generator=g)
        params = model.params
        pairwise = model.pairwise_scores(params, users, items)
        tiled = model.score(params, users.repeat(5), items.reshape(-1)).reshape(5, B)
        assert torch.equal(pairwise, tiled)
        ref = hybrid_epochs.scores(params, fitted['metadata'], users, items, stage)
        torch.testing.assert_close(pairwise, ref, rtol=1e-6, atol=1e-6)
    finally:
        model.set_stage(was)


def test_the_reference_imports_none_of_the_packages():
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import portbench.reference.hybrid_epochs; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "collie_tpu", "collie_tpu_torch")); '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code, str(REPO)], check=True, timeout=120)
