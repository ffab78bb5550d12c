"""Milliseconds a request spends on the host before its first launch on
the card: the program's ``collie.recommend.prepare`` spans (the ``k``
check, the seen set when filtering, the retrieval function, the params,
the user ids' upload), summed, over the window's requests
(``portbench.request`` spans)."""
from portbench.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, 'collie.recommend.prepare', 'portbench.request')
