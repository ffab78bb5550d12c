"""The port's NeuMF training against the benchmark's plain reference
(``portbench/reference/neumf_epochs.py``), on the CPU at a small size.

A ``NeuralCollaborativeFiltering(embedding_dim=8, num_layers=3)`` with an
adaptive hinge over 4 negatives, on 60 users x 40 items, trains two epochs
of 64-row batches through ``CollieTrainer.fit``: the generic epoch on the
fused tables, the sparse-hardest selection.  Its weights are seeded random
ones (Normal(0, 0.3) on every leaf), so the MLP is awake from the first
step.  Every ``scan_engine.train_step`` call is recorded: its state before
and after and its rows.  The reference then trains the same two epochs
(``mf_epochs.ImplicitData`` works the batches out again) from the same
weights, and also takes each recorded step again from the program's own
state before it.  Nothing here imports JAX's package; the reference is held
to import none of the packages.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from collie_tpu_torch import CollieTrainer, InteractionsDataLoader, NeuralCollaborativeFiltering
from collie_tpu_torch.data import Interactions
from collie_tpu_torch.training import scan_engine

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.reference import mf_epochs, neumf_epochs  # noqa: E402

U, I, D, L, K, B, LR, SEED = 60, 40, 8, 3, 4, 64, 1e-3, 11

#: the loss's relative gap: the same float32 arithmetic summed in another
#: order (fused gathers, autograd's scatter order) rounds at ~1e-7
LOSS_RTOL = 1e-5
#: Adam's first moments (norm of the difference over the leaf's norm): one
#: step from the same state rounds its gradients' sums apart at ~1e-7
MOMENT_TOL = 1e-6
#: the same after a whole epoch of 12 steps, each from states already apart:
#: ~1e-6
EPOCH_MOMENT_TOL = 1e-5
#: the tables' change: a parameter near 0.3 has a float32 spacing of ~3e-8,
#: so a change of ~1e-3 a step is read to ~3e-5 of itself whenever one
#: rounding of the update falls on the other side
DELTA_TOL = 1e-4


@pytest.fixture(scope='module')
def fitted():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)        # several threads scatter-add in a run-dependent order
    try:
        rng = np.random.default_rng(5)
        keys = np.unique(rng.integers(0, U * I, 900))
        users, items = keys // I, keys % I
        inter = Interactions(users=users, items=items, num_users=U, num_items=I,
                             num_negative_samples=K, allow_missing_ids=True, seed=SEED)
        loader = InteractionsDataLoader(interactions=inter, batch_size=B, shuffle=True,
                                        seed=SEED)
        model = NeuralCollaborativeFiltering(train=loader, embedding_dim=D, num_layers=L,
                                             loss='adaptive', lr=LR, seed=3,
                                             map_location='cpu')
        generator = torch.Generator().manual_seed(7)
        init = {k: 0.3 * torch.randn(v.shape, generator=generator)
                for k, v in model.params.items()}
        model.load_params(init)
        steps = []
        real = scan_engine.train_step

        def recording(model, specs, active, params, opt_states, batch, generator=None,
                      fused_tables=False, mesh=None, loss_scale=None):
            def named(p):
                p = model.unfuse_params(p) if fused_tables else p
                return {k: v.detach().clone() for k, v in p.items()}
            state = opt_states[0]
            before = {'params': named(params), 'mu': {k: v.clone() for k, v in state.mu.items()},
                      'nu': {k: v.clone() for k, v in state.nu.items()},
                      't': int(state.adam_count)}
            out = real(model, specs, active, params, opt_states, batch, generator,
                       fused_tables, mesh, loss_scale)
            steps.append({'before': before, 'batch': {k: v.clone() for k, v in batch.items()},
                          'params': named(out[0]), 'fused_tables': fused_tables,
                          'mu': {k: v.clone() for k, v in out[1][0].mu.items()},
                          'loss': float(out[2])})
            return out

        scan_engine.train_step = recording
        try:
            trainer = CollieTrainer(model, max_epochs=2, seed=SEED, verbosity=0, logger=False,
                                    enable_model_summary=False)
            trainer.fit(model)
        finally:
            scan_engine.train_step = real
        data = mf_epochs.ImplicitData(users, items, U, I, 'cpu')
        reference = neumf_epochs.train_epochs(init, [data.epoch(SEED, e, B, K) for e in (1, 2)],
                                              lr=LR, num_layers=L)
        final = {k: v.detach().clone() for k, v in model.params.items()}
        yield {'model': model, 'init': init, 'steps': steps, 'reference': reference,
               'final': final}
    finally:
        torch.set_num_threads(threads)


def test_the_fit_takes_the_generic_epoch_and_the_sparse_selection(fitted):
    model, steps = fitted['model'], fitted['steps']
    assert model.selection_route(K) == 'sparse'
    assert steps and all(s['fused_tables'] for s in steps)
    assert len(steps) % 2 == 0


def test_epoch_losses_match(fitted):
    steps, reference = fitted['steps'], fitted['reference']
    per_epoch = len(steps) // 2
    program = [np.mean([s['loss'] for s in steps[:per_epoch]]),
               np.mean([s['loss'] for s in steps[per_epoch:]])]
    np.testing.assert_allclose(program, reference['loss'], rtol=LOSS_RTOL)


def test_first_epoch_moments_and_the_tables_change_match(fitted):
    steps, reference, init = fitted['steps'], fitted['reference'], fitted['init']
    grads = reference['moments']
    moments = steps[len(steps) // 2 - 1]['mu']
    errors = neumf_epochs.leaf_errors(moments, grads, grads)
    # the predict layer's bias gets no gradient from a pairwise loss (the
    # positive's and the negative's shares cancel): left out as rounding noise
    assert 'predict_bias' not in errors and len(errors) == len(grads) - 1
    assert max(errors.values()) < EPOCH_MOMENT_TOL, errors
    delta = {k: fitted['final'][k] - init[k] for k in init}
    ref_delta = {k: reference['params'][1][k] - init[k] for k in init}
    errors = neumf_epochs.leaf_errors(delta, ref_delta, grads)
    assert max(errors.values()) < DELTA_TOL, errors


def test_each_step_matches_from_the_programs_own_state(fitted):
    for s in fitted['steps']:
        ref = neumf_epochs.step(s['before'], s['batch'], lr=LR, num_layers=L)
        assert abs(s['loss'] - ref['loss']) <= LOSS_RTOL * abs(ref['loss'])
        assert max(neumf_epochs.leaf_errors(s['mu'], ref['mu'], ref['mu']).values()) \
            < MOMENT_TOL
        before = s['before']['params']
        errors = neumf_epochs.leaf_errors({k: s['params'][k] - before[k] for k in before},
                                          {k: ref['params'][k] - before[k] for k in before},
                                          ref['mu'])
        assert max(errors.values()) < DELTA_TOL, errors


def test_a_lower_precision_or_half_the_rows_fails_the_step_check(fitted):
    """bfloat16 and a half batch in the program's place read far above the
    tolerances (TF32 is the CPU's float32 and is checked on the card)."""
    s = fitted['steps'][len(fitted['steps']) // 2]
    ref = neumf_epochs.step(s['before'], s['batch'], lr=LR, num_layers=L)
    for kwargs in ({'dtype': torch.bfloat16}, {'drop_half': True}):
        got = neumf_epochs.step(s['before'], s['batch'], lr=LR, num_layers=L, **kwargs)
        assert max(neumf_epochs.leaf_errors(got['mu'], ref['mu'], ref['mu']).values()) \
            > 100 * MOMENT_TOL


def test_the_reference_imports_none_of_the_packages():
    code = ('import sys; sys.path.insert(0, sys.argv[1]); '
            'import portbench.reference.neumf_epochs; '
            'bad = sorted(m for m in sys.modules if m.split(".")[0] in '
            '("jax", "jaxlib", "collie_tpu", "collie_tpu_torch")); '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code, str(REPO)], check=True, timeout=120)
