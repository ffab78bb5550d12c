"""Device operations a training step costs: every operation on the card
in the traced window (kernels, copies, sets; the epoch's shuffle and
sampler included) over the program's ``collie.fit.step`` spans in it."""
from portbench.metrics._spans import named


def read(run):
    trace = run.trace
    if trace is None:
        return None
    steps = len(named(trace, 'collie.fit.step'))
    if steps == 0 or not trace.op_names:
        return None
    return len(trace.op_names) / steps
