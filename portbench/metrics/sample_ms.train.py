"""Milliseconds an epoch spends in the sampler and the batch assembly
(``epoch_log`` ``sample_ms``, CUDA events; for explicit data the batch
gather alone), summed over the window's epochs, over the epochs."""
from portbench.metrics._common import epoch_split_ms


def read(run):
    return epoch_split_ms(run, 'sample_ms')
