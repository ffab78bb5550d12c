"""Whole runs of the harness on the CPU at tiny sizes (``tiny_root``): the
result line, the traced run's metrics, and ``correct`` coming out false
when the timed path is broken underneath."""
import json
import time

import pytest

from portbench import harness

CELLS = ['mf_ml10m.fit_implicit', 'mf_msd.recommend_batch', 'mf_msd.recommend_seen',
         'mf_ml10m.fit_explicit']


def run_cell(root, cell, capsys, trace=0, seconds=0.5):
    import torch
    rc = harness.main(['--workload', cell, '--seed', '4294967311', '--seconds', str(seconds),
                       '--trace', str(trace)], time.perf_counter(), root,
                      device=torch.device('cpu'))
    out, err = capsys.readouterr()
    assert rc == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == 'checks'
    assert err.strip().splitlines()[-1].startswith('check ')
    return result


@pytest.mark.parametrize('cell', CELLS)
def test_run_reports_end_to_end_metrics(tiny_root, cell, capsys):
    from portbench import spec
    result = run_cell(tiny_root, cell, capsys)
    wanted = {m['name'] for m in spec.end_to_end_for(spec.load_spec(tiny_root), cell)}
    assert set(result['metrics']) == wanted
    assert all(m['value'] > 0 for m in result['metrics'].values())
    assert result['attempted'] >= 1 and result['failed'] == 0
    assert result['device']['platform'] == 'cpu'
    for name, check in result['checks'].items():
        assert check['value'] >= 0, name
    assert result['checks'].get('batch_mismatch', {'value': 0})['value'] == 0
    assert result['checks'].get('bad_ids', {'value': 0})['value'] == 0


@pytest.mark.parametrize('cell', ['mf_msd.recommend_batch', 'mf_ml10m.fit_explicit'])
def test_traced_run_reports_per_layer_metrics(tiny_root, cell, capsys):
    result = run_cell(tiny_root, cell, capsys, trace=1)
    assert result['device']['window_s'] > 0
    assert set(result['breakdown']) == {'device_ops', 'idle_gaps'}
    # the CPU has no device trace: only host-side readings appear
    assert all(m['unit'] for m in result['metrics'].values())
    if cell == 'mf_ml10m.fit_explicit':
        assert {'fit_host_ms.train', 'sample_ms.train', 'mfu.train'} <= set(result['metrics'])
    else:
        assert 'mfu.serve' in result['metrics']


def _break_epoch(monkeypatch, how, after=0):
    """Break the timed path underneath the trainer: the epoch function
    returns the state it got, or trains on half of every batch; from its
    ``after + 1``-th epoch on."""
    import torch
    from collie_tpu_torch.training import scan_engine

    calls = [0]
    for name in ('fused_mf_epoch', 'fused_mf_explicit_epoch'):
        real = getattr(scan_engine, name)

        def broken(*args, _real=real, _name=name, **kwargs):
            calls[0] += 1
            if calls[0] <= after:
                return _real(*args, **kwargs)
            args = list(args)
            if how == 'unchanged':
                out = _real(*args, **kwargs)
                n_state = 8 if _name == 'fused_mf_explicit_epoch' else 7
                return (*args[:n_state], args[n_state], out[-1])
            mask_at = 12 if _name == 'fused_mf_explicit_epoch' else 11
            mask = args[mask_at].clone()
            mask[:, mask.shape[1] // 2:] = 0
            args[mask_at] = mask
            return _real(*args, **kwargs)
        monkeypatch.setattr(scan_engine, name, broken)
    return torch


@pytest.mark.parametrize('how', ['unchanged', 'half_batch'])
@pytest.mark.parametrize('cell', ['mf_ml10m.fit_implicit', 'mf_ml10m.fit_explicit'])
def test_broken_training_is_not_correct(tiny_root, cell, how, capsys, monkeypatch):
    _break_epoch(monkeypatch, how)
    assert run_cell(tiny_root, cell, capsys)['correct'] is False


@pytest.mark.parametrize('how', ['unchanged', 'half_batch'])
@pytest.mark.parametrize('cell', ['mf_ml10m.fit_implicit', 'mf_ml10m.fit_explicit'])
def test_training_broken_after_the_first_fit_is_not_correct(tiny_root, cell, how, capsys,
                                                            monkeypatch):
    """Set-up's fit is sound, every fit of the window is broken: the
    window's first fit is checked too."""
    from portbench import spec
    epochs = spec.traffic_file(spec.workload(spec.load_spec(tiny_root), cell)['traffic'],
                               tiny_root)['epochs_per_fit']
    _break_epoch(monkeypatch, how, after=epochs)
    result = run_cell(tiny_root, cell, capsys)
    assert result['correct'] is False, result['checks']


@pytest.mark.parametrize('cell', ['mf_msd.recommend_batch', 'mf_msd.recommend_seen'])
def test_altered_answer_is_not_correct(tiny_root, cell, capsys, monkeypatch):
    from collie_tpu_torch import retrieval

    real = retrieval.build_retrieval_fn

    def altered_build(*args, **kwargs):
        fn = real(*args, **kwargs)

        def retrieve(*a, **kw):
            ids, scores = fn(*a, **kw)
            ids = ids.clone()
            ids[0, 0] = ids[0, -1]
            return ids, scores
        return retrieve
    monkeypatch.setattr(retrieval, 'build_retrieval_fn', altered_build)
    assert run_cell(tiny_root, cell, capsys)['correct'] is False
