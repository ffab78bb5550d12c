"""Milliseconds a fit spends in its set-up, before its first epoch: the
program's ``collie.fit.setup`` spans (mesh checks, params, epoch tables,
step functions, report, optimizer states), summed over the window, over the
window's fits (``portbench.fit`` spans)."""
from portbench.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, 'collie.fit.setup', 'portbench.fit')
