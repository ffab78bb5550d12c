"""Milliseconds of the selection kernel a request: the device time of the
operations whose names hold ``topk_select`` (``csrc/topk_select.cu``: its
pass over the scores and, where a row takes several segments, the merge of
the segments) in the traced window, over the window's requests
(``portbench.request`` spans).  A program without the kernel reads None."""
from portbench.metrics._spans import calls


def read(run):
    requests = calls(run, 'portbench.request')
    if requests is None:
        return None
    seconds, launches = run.trace.op_seconds('topk_select')
    if launches == 0:
        return None
    return 1e3 * seconds / len(requests)
