"""The combined MLP's matrix products' share of their roofline: the layer
products of every metadata-stage epoch the window's jobs ran
(``_counts_hybrid``: the selection forward of K B pairs, the positive and
the hardest negative forward and backward, at 67 TFLOP/s; none in the MF
stage) over the device time of the matrix-product kernels in the traced
window, found by name as ``mlp_gemm_roofline.neumf`` finds them."""
import numpy as np

from portbench import spec
from portbench.metrics import _counts
from portbench.metrics._counts_hybrid import window_counts

is_gemm = spec.metric_module('mlp_gemm_roofline.neumf').is_gemm


def read(run):
    counts = window_counts(run)
    trace = run.trace
    if counts is None or trace is None or not trace.op_names:
        return None
    pick = np.asarray([is_gemm(n) for n in trace.op_names], dtype=bool)
    if not pick.any():
        return None
    seconds = float((trace.op_end[pick] - trace.op_start[pick]).sum()) / 1e9
    return 100.0 * counts['gemm'] / _counts.PEAK_FP32_FLOPS / seconds
