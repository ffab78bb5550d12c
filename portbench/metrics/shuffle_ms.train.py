"""Milliseconds an epoch spends in the shuffle (``epoch_log``
``shuffle_ms``, CUDA events), summed over the window's epochs, over the
epochs."""
from portbench.metrics._common import epoch_split_ms


def read(run):
    return epoch_split_ms(run, 'shuffle_ms')
