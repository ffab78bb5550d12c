"""The operations of a staged ``HybridModel`` epoch (an adaptive loss, no
metadata towers, the generic epoch), counted from the shapes as
``_counts`` counts MF's and ``_counts_neumf`` NeuMF's: the work the
configured mathematics needs, whichever code does it.

A pair is one (user, item) scored.  In the ``matrix_factorization`` stage
the MF dot product (2D) and the two bias adds; its gradient, 4D a pair.
In the metadata stages the combined MLP over ``concat(u, i, item
metadata)``, ``2D + F`` wide: ``2 in out`` a layer's product, ``out`` its
bias add, then the two id biases; a backward pass costs twice a
forward's layer products (the input's and the weight's gradients).  Per
step of B rows with K negatives: the selection pass scores K B pairs
forward without gradient, then the positive and the hardest negative, 2 B
pairs, forward and backward; then the stage's optimizers, densely: Adam
(``_counts.ADAM_FLOPS`` an element) on the embedding tables and SGD on the
biases in ``matrix_factorization``, Adam on the combined layers and the
biases in ``metadata_only``, Adam on every leaf in ``all``.
"""
from typing import Dict, List, Optional, Tuple

from portbench.metrics._counts import ADAM_FLOPS, SGD_FLOPS

MF_STAGE = 'matrix_factorization'


def combined_widths(D: int, F: int, dims: List[int]) -> List[Tuple[int, int]]:
    """``(in, out)`` of each combined layer, ending in one unit."""
    ins = [2 * D + F] + list(dims)
    return list(zip(ins, list(dims) + [1]))


def gemm_flops_per_pair(D: int, F: int, dims: List[int]) -> int:
    """The combined layers' matrix products in one pair's forward."""
    return sum(2 * a * b for a, b in combined_widths(D, F, dims))


def combined_params(D: int, F: int, dims: List[int]) -> int:
    return sum(a * b + b for a, b in combined_widths(D, F, dims))


def step_counts(shape: dict, stage: str) -> Dict[str, float]:
    """One step's operations in ``stage``: ``gemm`` (the combined layers'
    products, forward and backward, of the selection and the gradient
    pass; none in the MF stage) and ``total`` (with the dot products, bias
    adds and the optimizers)."""
    U, I, D, F = shape['num_users'], shape['num_items'], shape['dim'], shape['metadata_cols']
    B, K, dims = shape['batch'], shape['negatives'], shape['combined_dims']
    tables, biases = (U + I) * D, U + I
    if stage == MF_STAGE:
        return {'gemm': 0.0,
                'total': float(K * B * (2 * D + 2) + 2 * B * (2 * D + 2 + 4 * D)
                               + tables * ADAM_FLOPS + biases * SGD_FLOPS)}
    gemm = gemm_flops_per_pair(D, F, dims)
    forward = gemm + sum(b for _, b in combined_widths(D, F, dims)) + 2
    trained = combined_params(D, F, dims) + biases + (tables if stage == 'all' else 0)
    return {'gemm': float(K * B * gemm + 2 * B * 3 * gemm),
            'total': float(K * B * forward + 2 * B * (forward + 2 * gemm)
                           + trained * ADAM_FLOPS)}


def epoch_counts(shape: dict, stage: str) -> Dict[str, float]:
    """An epoch's operations in ``stage`` (``step_counts`` times its steps),
    from the driver's ``shape``."""
    return {k: v * shape['steps'] for k, v in step_counts(shape, stage).items()}


def window_counts(run) -> Optional[Dict[str, float]]:
    """The operations of every epoch the window's stage fits ran, or None
    without fits."""
    fits = run.inputs.get('fits')
    if not fits:
        return None
    out = {'gemm': 0.0, 'total': 0.0}
    for fit in fits:
        for key, value in epoch_counts(run.inputs['shape'], fit['stage']).items():
            out[key] += len(fit['log']) * value
    return out
