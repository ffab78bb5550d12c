"""The epoch kernel's share of its roofline: the least time of one epoch
(``_counts.implicit_epoch`` / ``explicit_epoch``) times the launches in the
traced window, over the device time of the cell's epoch kernel, found by
name in the trace."""
from portbench.metrics import _counts
from portbench.metrics._common import epoch_counts


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.op_seconds(run.inputs['shape']['epoch_kernel'])
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * _counts.least_seconds(*epoch_counts(run)) / seconds
