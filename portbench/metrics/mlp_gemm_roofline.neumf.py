"""The MLP's matrix products' share of their roofline: the layer products
of every epoch the window's fits ran (``_counts_neumf``: the MLP and the
predict layer, forward and backward, at 67 TFLOP/s) over the device time
of the matrix-product kernels in the traced window, found by name
(``is_gemm``)."""
import numpy as np

from portbench.metrics import _counts
from portbench.metrics._counts_neumf import epoch_counts

#: the parts of cuBLAS kernel names that compute matrix products (``gemm``,
#: ``gemv``, the split-K reduction of a product): the training step's other
#: kernels (gathers, scatters, element-wise, reductions, sorts) hold none
GEMM_PARTS = ('gemm', 'gemv', 'splitkreduce')


def is_gemm(name: str) -> bool:
    low = name.lower()
    return any(part in low for part in GEMM_PARTS)


def read(run):
    fits = run.inputs.get('fits')
    trace = run.trace
    if not fits or trace is None or not trace.op_names:
        return None
    pick = np.asarray([is_gemm(n) for n in trace.op_names], dtype=bool)
    if not pick.any():
        return None
    seconds = float((trace.op_end[pick] - trace.op_start[pick]).sum()) / 1e9
    epochs = sum(len(f['log']) for f in fits)
    least = epochs * epoch_counts(run.inputs['shape'])['gemm'] / _counts.PEAK_FP32_FLOPS
    return 100.0 * least / seconds
