"""Host waits on the card a fit makes: the program's ``collie.sync`` spans
inside its ``collie.fit`` spans (a flight's one transfer, each read of CUDA
events, each loss read back), over the window's fits (``portbench.fit``
spans)."""
from portbench.metrics._spans import count_per_call


def read(run):
    return count_per_call(run, 'collie.sync', 'collie.fit', 'portbench.fit')
