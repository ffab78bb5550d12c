"""The served requests' share of the FP32 peak: ``2 B I D`` and the bias
adds for every request of the window (``_counts.topk_request``, the same
work whichever path serves it) over the window's time and 67 TFLOP/s."""
from portbench.metrics._common import serve_mfu


def read(run):
    return serve_mfu(run)
