"""The NeuMF fits' share of the FP32 peak: the operations of every epoch
the window's fits ran (``_counts_neumf``, from the shapes: the selection
pass, the gradient pass forward and backward, the GMF products, dense Adam;
whichever code does the work) over the window's time and 67 TFLOP/s."""
from portbench.metrics import _counts
from portbench.metrics._counts_neumf import epoch_counts


def read(run):
    fits = run.inputs.get('fits')
    if not fits:
        return None
    epochs = sum(len(f['log']) for f in fits)
    flops = epochs * epoch_counts(run.inputs['shape'])['total']
    return 100.0 * flops / run.inputs['window_s'] / _counts.PEAK_FP32_FLOPS
