"""Milliseconds a training step takes on the host: the mean of the
program's ``collie.fit.step`` spans (each generic ``train_step``: the
selection pass, the gradient pass and the optimizers' updates enqueued)
in the traced window.  Beside the device time a step, it says whether the
Python step loop or the card sets the pace."""
from portbench.metrics._spans import named


def read(run):
    if run.trace is None:
        return None
    steps = named(run.trace, 'collie.fit.step')
    if len(steps) == 0:
        return None
    return float((steps[:, 1] - steps[:, 0]).mean()) / 1e6
