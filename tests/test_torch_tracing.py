"""The port's own spans (``training/profiler.annotate``) inside
``CollieTrainer.fit`` and ``retrieval.recommend``, read from a
``torch.profiler`` trace on the CPU.

A fit opens ``collie.fit`` and, inside it in turn, ``collie.fit.setup``
(which holds ``collie.fit.epoch_tables`` > ``collie.fit.sampler_tables``
and ``collie.fit.opt_states``), ``collie.fit.epochs`` and
``collie.fit.finish``; a request opens ``collie.recommend`` >
``collie.recommend.prepare`` (> ``collie.recommend.seen`` with the seen
filter).  ``collie.sync`` marks each deliberate host wait: on the CPU a
whole fit's one transfer a flight, the per-epoch loop's loss reads and a
request's copy of its answer (the CUDA-event waits exist on the card
alone).  With no profiler running ``annotate`` never reaches
``record_function`` and the results are bit for bit those of a traced run.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from collie_tpu_torch import (CollieTrainer, HDF5InteractionsDataLoader,
                              MatrixFactorizationModel, write_hdf5_meta)
from collie_tpu_torch.data import ExplicitInteractions, Interactions
from collie_tpu_torch.retrieval import recommend
from collie_tpu_torch.training import profiler

NU, NI, N = 30, 50, 400


@pytest.fixture(autouse=True)
def one_thread():
    # several threads scatter-add duplicate rows in a run-dependent order
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pairs(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, NU, N), rng.integers(0, NI, N), rng


def _implicit(seed=0):
    users, items, _ = _pairs(seed)
    return Interactions(users=users, items=items, num_users=NU, num_items=NI,
                        allow_missing_ids=True, check_num_negative_samples_is_valid=False,
                        seed=seed)


def _model(kind, tmp_path):
    if kind == 'explicit':
        users, items, rng = _pairs(1)
        keys = np.unique(users * NI + items)
        train = ExplicitInteractions(users=keys // NI, items=keys % NI,
                                     ratings=rng.integers(1, 6, len(keys)).astype(np.float32),
                                     num_users=NU, num_items=NI, allow_missing_ids=True)
        return MatrixFactorizationModel(train=train, embedding_dim=4, loss='mse', seed=0,
                                        map_location='cpu')
    if kind == 'hdf5':
        import h5py
        users, items, _ = _pairs(2)
        path = str(tmp_path / 'store.h5')
        with h5py.File(path, 'w') as f:
            group = f.require_group('interactions')
            group.create_dataset('user_id', data=users.astype(np.int32))
            group.create_dataset('item_id', data=items.astype(np.int32))
        write_hdf5_meta(path, NU, NI)
        loader = HDF5InteractionsDataLoader(hdf5_path=path, batch_size=128, shuffle=True,
                                            num_negative_samples=3, seed=0)
        return MatrixFactorizationModel(train=loader, embedding_dim=4, seed=0,
                                        map_location='cpu')
    val = _implicit(3) if kind == 'implicit_val' else None
    return MatrixFactorizationModel(train=_implicit(), val=val, embedding_dim=4, seed=0,
                                    map_location='cpu')


def _collie_spans(prof):
    """``(name, start_ns, end_ns)`` of every ``collie.*`` host span."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith('collie.'):
            out.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _named(spans, name):
    return [(s, e) for n, s, e in spans if n == name]


def _inside(child, parents):
    return any(s <= child[0] and child[1] <= e for s, e in parents)


def _whole_fit_flights(epochs):
    """Flights of a whole fit of ``epochs`` epochs: greedy power-of-two
    blocks of at most 16, four blocks a flight (``trainer._run_fit_scan``)."""
    blocks, left = 0, epochs
    while left:
        b = 16
        while b > left:
            b //= 2
        blocks, left = blocks + 1, left - b
    return -(-blocks // 4)


#: (model kind, COLLIE_TPU_WHOLE_FIT, epochs, epoch-table builds, sampler-table
#: builds, host waits on the CPU)
FITS = [
    ('implicit', '1', 10, 1, 1, _whole_fit_flights(10)),
    ('implicit', '1', 31, 1, 1, _whole_fit_flights(31)),       # 16+8+4+2+1: two flights
    ('implicit', '0', 3, 1, 1, 3),                  # one loss read an epoch
    ('implicit_val', '1', 5, 2, 2, _whole_fit_flights(5)),
    ('implicit_val', '0', 3, 2, 2, 6),              # the train and val loss reads
    ('explicit', '1', 10, 1, 1, _whole_fit_flights(10)),
    ('explicit', '0', 3, 1, 1, 3),
    ('hdf5', '1', 3, 1, 0, 3),                      # the chunk tier's loss read an epoch
]


@pytest.mark.parametrize('kind,whole,epochs,tables,samplers,syncs', FITS)
def test_fit_spans_nest_and_count_host_waits(kind, whole, epochs, tables, samplers, syncs,
                                             tmp_path, monkeypatch):
    monkeypatch.setenv('COLLIE_TPU_WHOLE_FIT', whole)
    monkeypatch.setenv('COLLIE_TPU_HDF5_CHUNK_STEPS', '4')
    model = _model(kind, tmp_path)
    trainer = CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(model)
    spans = _collie_spans(prof)
    fit = _named(spans, 'collie.fit')
    assert len(fit) == 1
    (setup,), (epochs_span,), (finish,) = (_named(spans, f'collie.fit.{stage}')
                                           for stage in ('setup', 'epochs', 'finish'))
    assert all(_inside(span, fit) for span in (setup, epochs_span, finish))
    assert setup[1] <= epochs_span[0] and epochs_span[1] <= finish[0]
    built = _named(spans, 'collie.fit.epoch_tables')
    assert len(built) == tables and all(_inside(span, [setup]) for span in built)
    sampled = _named(spans, 'collie.fit.sampler_tables')
    assert len(sampled) == samplers and all(_inside(span, built) for span in sampled)
    (opt,) = _named(spans, 'collie.fit.opt_states')
    assert _inside(opt, [setup])
    waits = _named(spans, 'collie.sync')
    assert len(waits) == syncs and all(_inside(span, [epochs_span]) for span in waits)
    assert trainer.num_epochs_completed == epochs


@pytest.mark.parametrize('filter_seen', [True, False])
def test_recommend_spans(filter_seen):
    model = MatrixFactorizationModel(train=_implicit(), embedding_dim=4, seed=0,
                                     map_location='cpu')
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ids, scores = recommend(model, np.arange(7), k=5, filter_seen=filter_seen)
    assert ids.shape == scores.shape == (7, 5)
    spans = _collie_spans(prof)
    (call,) = _named(spans, 'collie.recommend')
    (prepare,) = _named(spans, 'collie.recommend.prepare')
    assert _inside(prepare, [call])
    seen = _named(spans, 'collie.recommend.seen')
    assert len(seen) == int(filter_seen) and all(_inside(span, [prepare]) for span in seen)
    (wait,) = _named(spans, 'collie.sync')
    assert _inside(wait, [call]) and prepare[1] <= wait[0]


def _fit_and_serve():
    model = MatrixFactorizationModel(train=_implicit(), embedding_dim=4, seed=0,
                                     map_location='cpu')
    CollieTrainer(model, max_epochs=3, verbosity=0, seed=0).fit(model)
    ids, scores = recommend(model, np.arange(NU), k=5)
    return {k: v.clone() for k, v in model.params.items()}, ids, scores


def test_annotate_is_free_without_a_profiler(monkeypatch):
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiler.annotate('x'), torch.profiler.record_function)
        traced = _fit_and_serve()

    def refuse(name):
        raise AssertionError(f'record_function({name!r}) entered with no profiler running')

    monkeypatch.setattr(profiler, 'record_function', refuse)
    assert profiler.annotate('x') is profiler.annotate('y')
    params, ids, scores = _fit_and_serve()
    assert set(params) == set(traced[0])
    assert all(torch.equal(params[k], traced[0][k]) for k in params)
    assert np.array_equal(ids, traced[1]) and np.array_equal(scores, traced[2])


@pytest.mark.parametrize('model_kind', ['neumf', 'mf_fused'])
def test_generic_epoch_steps_each_hold_one_selection(model_kind, monkeypatch):
    """The generic epoch opens a ``collie.fit.step`` span a step, inside
    ``collie.fit.epochs``, each holding one ``collie.loss.select`` (the
    sparse loss's selection pass); the fused MF epoch (its plain version on
    the CPU) opens neither."""
    from collie_tpu_torch import InteractionsDataLoader, NeuralCollaborativeFiltering
    from collie_tpu_torch.training import scan_engine

    loader = InteractionsDataLoader(interactions=_implicit(), batch_size=64, shuffle=True,
                                    seed=0)
    if model_kind == 'neumf':
        model = NeuralCollaborativeFiltering(train=loader, embedding_dim=4, num_layers=2,
                                             loss='adaptive', seed=0, map_location='cpu')
        assert model.selection_route(loader.num_negative_samples) == 'sparse'
    else:
        monkeypatch.setenv('COLLIE_TPU_FUSED_EPOCH', '1')
        model = MatrixFactorizationModel(train=loader, embedding_dim=4, seed=0,
                                         map_location='cpu')
    calls = [0]
    real = scan_engine.train_step

    def counting(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(scan_engine, 'train_step', counting)
    epochs = 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CollieTrainer(model, max_epochs=epochs, verbosity=0, seed=0).fit(model)
    spans = _collie_spans(prof)
    steps, selects = _named(spans, 'collie.fit.step'), _named(spans, 'collie.loss.select')
    if model_kind == 'mf_fused':
        assert calls[0] == 0 and not steps and not selects
        return
    assert calls[0] > 0 and calls[0] % epochs == 0
    assert len(steps) == calls[0] and len(selects) == len(steps)
    assert all(_inside(step, _named(spans, 'collie.fit.epochs')) for step in steps)
    assert all(sum(_inside(select, [step]) for select in selects) == 1 for step in steps)


def test_hybrid_stage_and_metadata_spans_and_the_metadata_row_counter():
    """A staged hybrid fit: each ``set_stage`` (``advance_stage`` too) is a
    ``collie.fit.stage`` span; the metadata stages' steps each hold two
    ``collie.hybrid.metadata`` spans (the selection's scores and the
    gradient pass's), the MF stage's none; the program counter
    ``collie.hybrid.metadata_rows`` counts ``K + 2`` rows a batch row
    inside a traced ``counting()`` region, and nothing outside a trace."""
    from collie_tpu_torch import HybridModel, InteractionsDataLoader

    B = 64
    inter = _implicit()
    K = inter.num_negative_samples
    loader = InteractionsDataLoader(interactions=inter, batch_size=B, shuffle=True, seed=0)
    meta = np.random.default_rng(0).random((NI, 5)).astype(np.float32)
    model = HybridModel(train=loader, item_metadata=meta, embedding_dim=4,
                        combined_layers_dims=[8], loss='adaptive', seed=0, map_location='cpu')
    trainer = CollieTrainer(model, max_epochs=0, verbosity=0, seed=0)
    steps = -(-inter.num_interactions // B)
    with profiler.counting() as untraced:
        model.advance_stage()
        trainer.max_epochs += 1
        trainer.fit(model)
    assert not untraced
    model.set_stage('matrix_factorization')
    with profile(activities=[ProfilerActivity.CPU]) as prof, profiler.counting() as counts:
        for n in range(3):
            if n:
                model.advance_stage()
            trainer.max_epochs += 1
            trainer.fit(model)
    spans = _collie_spans(prof)
    assert len(_named(spans, 'collie.fit.stage')) == 2
    fits = _named(spans, 'collie.fit')
    meta_spans = _named(spans, 'collie.hybrid.metadata')
    assert not any(_inside(m, fits[:1]) for m in meta_spans)
    for fit in fits[1:]:
        fit_steps = [s for s in _named(spans, 'collie.fit.step') if _inside(s, [fit])]
        assert len(fit_steps) == steps
        assert all(sum(_inside(m, [s]) for m in meta_spans) == 2 for s in fit_steps)
    assert counts == {'collie.hybrid.metadata_rows': 2 * steps * B * (K + 2)}
