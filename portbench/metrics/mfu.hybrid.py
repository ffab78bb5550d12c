"""The staged jobs' share of the FP32 peak: the operations of every stage
epoch the window's jobs ran (``_counts_hybrid``, from the shapes: the MF
stage's dot products, the metadata stages' selection and gradient passes
through the combined MLP, the optimizers; whichever code does the work)
over the window's time and 67 TFLOP/s."""
from portbench.metrics import _counts
from portbench.metrics._counts_hybrid import window_counts


def read(run):
    counts = window_counts(run)
    if counts is None:
        return None
    return 100.0 * counts['total'] / run.inputs['window_s'] / _counts.PEAK_FP32_FLOPS
