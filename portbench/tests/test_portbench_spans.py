"""The readers of the program's own spans (``metrics/_spans.py``): known
values from a hand-built trace, None where the program opens no such span,
and the four metrics in the line of a traced CPU run."""
import pytest

from portbench import harness, spec
from portbench.tests.conftest import REPO
from portbench.tests.test_portbench_harness import run_cell
from portbench.tracing import TraceSummary

SPAN_METRICS = ('fit_setup_ms.train', 'epoch_tables_ms.train', 'fit_syncs.train',
                'request_prep_ms.serve')


def _read(name, host):
    trace = TraceSummary([('k', 0, 1)], [('portbench.window', 0, 10 ** 9)] + host)
    return spec.metric_module(name, REPO).read(harness.Run({}, trace))


#: two fits (the second with a validation table) and a wait outside them
FITS = [('portbench.fit', 100, 9_000_100), ('collie.fit', 200, 9_000_000),
        ('collie.fit.setup', 300, 4_000_300), ('collie.fit.epoch_tables', 400, 3_000_400),
        ('collie.sync', 5_000_000, 5_000_100), ('collie.sync', 6_000_000, 6_000_100),
        ('collie.sync', 7_000_000, 7_000_100),
        ('portbench.fit', 10_000_000, 20_000_000), ('collie.fit', 10_000_100, 19_000_000),
        ('collie.fit.setup', 10_000_200, 12_000_200),
        ('collie.fit.epoch_tables', 10_000_300, 11_000_300),
        ('collie.fit.epoch_tables', 11_000_300, 11_500_300),
        ('collie.sync', 15_000_000, 15_000_100),
        ('collie.sync', 19_500_000, 19_600_000)]
REQUESTS = [('portbench.request', 0, 1_000_000), ('collie.recommend', 10, 990_000),
            ('collie.recommend.prepare', 20, 250_020), ('collie.sync', 900_000, 980_000),
            ('portbench.request', 2_000_000, 3_000_000),
            ('collie.recommend.prepare', 2_000_100, 2_150_100),
            ('collie.recommend.prepare', 5_000_000, 5_100_000)]


@pytest.mark.parametrize('name,host,value', [
    ('fit_setup_ms.train', FITS, (4.0 + 2.0) / 2),
    ('epoch_tables_ms.train', FITS, (3.0 + 1.0 + 0.5) / 2),
    ('fit_syncs.train', FITS, (3 + 1) / 2),      # the wait outside collie.fit not counted
    ('request_prep_ms.serve', REQUESTS, (0.25 + 0.15) / 2),
])
def test_span_readers_by_hand(name, host, value):
    assert _read(name, host) == pytest.approx(value)


@pytest.mark.parametrize('name', SPAN_METRICS)
def test_span_readers_without_the_spans(name):
    """A program without the spans (the benchmark's own spans alone) reads
    None, and so does a trace without the benchmark's spans."""
    own = [op for op in FITS + REQUESTS if op[0].startswith('portbench.')]
    assert _read(name, own) is None
    program = [op for op in FITS + REQUESTS if op[0].startswith('collie.')]
    assert _read(name, program) is None


def test_span_metrics_are_declared():
    loaded = spec.load_spec(REPO)
    declared = {m['name']: m for m in loaded['per_layer']}
    for name in SPAN_METRICS:
        assert declared[name]['source'] == 'program_span'
        assert callable(spec.metric_module(name, REPO).read)


@pytest.mark.parametrize('cell,wanted', [
    ('mf_ml10m.fit_implicit', ('fit_setup_ms.train', 'epoch_tables_ms.train',
                               'fit_syncs.train')),
    ('mf_msd.recommend_batch', ('request_prep_ms.serve',)),
    ('mf_msd.recommend_seen', ('request_prep_ms.serve',)),
])
def test_traced_run_reports_the_span_metrics(tiny_root, cell, wanted, capsys):
    result = run_cell(tiny_root, cell, capsys, trace=1)
    assert set(wanted) <= set(result['metrics'])
    assert all(result['metrics'][name]['value'] > 0 for name in wanted)
    if cell == 'mf_ml10m.fit_implicit':
        # on the CPU a whole fit of 3 epochs waits once: its one flight's transfer
        assert result['metrics']['fit_syncs.train']['value'] == 1
        setup = result['metrics']['fit_setup_ms.train']['value']
        assert result['metrics']['epoch_tables_ms.train']['value'] < setup
