"""Milliseconds a fit spends building its epoch tables: the program's
``collie.fit.epoch_tables`` spans (each ``build_scan_epoch_fns`` call: the
host packing, the sampler's complement tables, the uploads), summed over
the window, over the window's fits (``portbench.fit`` spans)."""
from portbench.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, 'collie.fit.epoch_tables', 'portbench.fit')
