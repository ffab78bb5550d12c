"""The operations of a NeuMF epoch (``NeuralCollaborativeFiltering`` with an
adaptive loss, the generic epoch), counted from the shapes as
``_counts`` counts MF's: the work the configured mathematics needs,
whichever code does it.

A pair is one (user, item) scored: the GMF product (D), the MLP's L
halving layers over ``concat(u_mlp, i_mlp)`` (``2 in out`` a layer and
``out`` for its bias), and the predict layer over ``concat(gmf, mlp)``
(``2 (2D) + 1``).  A backward pass costs twice a forward's layer products
(the input's and the weight's gradients).  Per step of B rows with K
negatives: the selection pass scores K B pairs forward without gradient,
then the positive and the hardest negative, 2 B pairs, forward and
backward; then dense Adam on every parameter (``_counts.ADAM_FLOPS`` an
element).
"""
from typing import Dict, List, Tuple

from portbench.metrics._counts import ADAM_FLOPS


def mlp_widths(D: int, L: int) -> List[Tuple[int, int]]:
    """``(in, out)`` of each MLP layer: ``D 2^(L-i)`` halved, per layer i."""
    return [(D * 2 ** (L - i), D * 2 ** (L - i - 1)) for i in range(L)]


def gemm_flops_per_pair(D: int, L: int) -> int:
    """The layer products of one pair's forward: the MLP's and the
    predict layer's matrix products, without bias adds."""
    return sum(2 * a * b for a, b in mlp_widths(D, L)) + 2 * (2 * D)


def forward_flops_per_pair(D: int, L: int) -> int:
    return (gemm_flops_per_pair(D, L) + sum(b for _, b in mlp_widths(D, L)) + 1   # biases
            + D)                                                               # GMF product


def num_params(U: int, I: int, D: int, L: int) -> int:
    tables = (U + I) * (D + D * 2 ** (L - 1))
    layers = sum(a * b + b for a, b in mlp_widths(D, L)) + 2 * D + 1
    return tables + layers


def step_counts(U: int, I: int, D: int, L: int, B: int, K: int) -> Dict[str, float]:
    """One step's operations: ``gemm`` (the layer products alone, forward
    and backward, of the selection and the gradient pass) and ``total``
    (with the GMF products, bias adds and Adam)."""
    fwd, gemm = forward_flops_per_pair(D, L), gemm_flops_per_pair(D, L)
    return {'gemm': float(K * B * gemm + 2 * B * 3 * gemm),
            'total': float(K * B * fwd + 2 * B * (fwd + 2 * gemm)
                           + num_params(U, I, D, L) * ADAM_FLOPS)}


def epoch_counts(shape: dict) -> Dict[str, float]:
    """An epoch's operations (``step_counts`` times its steps), from a
    driver's ``shape``."""
    per_step = step_counts(shape['num_users'], shape['num_items'], shape['dim'],
                           shape['layers'], shape['batch'], shape['negatives'])
    return {k: v * shape['steps'] for k, v in per_step.items()}
