"""The yardstick: published peaks of the card, and the operations and bytes
the configured mathematics needs, counted from the shapes.

Counting rules (one launch at a time): each input byte is read once and
each output byte written once, whatever a kernel reads again; the work is
what these inputs need, whichever code does it.  A least time is the larger
of operations over the FP32 peak and bytes over the memory bandwidth.
"""
from typing import Tuple

#: NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
#: bandwidth, at the card's full power limit of 700 W
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
F32 = I32 = 4
#: optax Adam on one element: two moments (7), two bias corrections, root,
#: eps, divide (5), the scaled step (2)
ADAM_FLOPS = 14
#: SGD on one element: the scaled step
SGD_FLOPS = 2


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S)


def implicit_epoch(U: int, I: int, D: int, S: int, B: int, K: int) -> Tuple[float, float]:
    """One launch of the implicit epoch: S steps of B rows.  Per step the
    forward scores of the positive and the K negatives (2D + 1 a pair), the
    gradient of the positive and the hardest negative only (the adaptive
    hinge takes one negative: 4D a pair for the two rows), the dense Adam
    update of both tables and SGD on the item biases.  Bytes: the tables,
    both moments and the item biases read and written once; the step's
    users, positives, negatives and mask read once; a loss a step written."""
    per_step = B * (1 + K) * (2 * D + 1) + B * 2 * 4 * D \
        + (U + I) * D * ADAM_FLOPS + I * SGD_FLOPS
    state = ((U + I) * D * 3 + I) * F32
    inputs = S * B * (3 + K) * I32
    return float(S * per_step), float(2 * state + inputs + S * F32)


def explicit_epoch(U: int, I: int, D: int, S: int, B: int) -> Tuple[float, float]:
    """One launch of the explicit epoch: per step the score (2D + 2 a row)
    with the y-range sigmoid, the gradient of both rows (4D), dense Adam on
    both tables and SGD on both bias vectors.  Bytes as the implicit epoch,
    with both biases, and users, items, ratings and mask as inputs."""
    per_step = B * (2 * D + 2) + B * 4 * D + (U + I) * D * ADAM_FLOPS + (U + I) * SGD_FLOPS
    state = ((U + I) * D * 3 + U + I) * F32
    inputs = S * B * 4 * F32
    return float(S * per_step), float(2 * state + inputs + S * F32)


def topk_request(B: int, I: int, D: int, k: int) -> Tuple[float, float]:
    """One top-k request over the catalog: every item scored for every
    user (2D a pair, plus the biases); bytes: the item table and biases and
    the B user rows and biases read once, B x k ids and scores written."""
    flops = B * I * (2 * D + 2)
    nbytes = (I * (D + 1) + B * (D + 1)) * F32 + B * k * (I32 + F32)
    return float(flops), float(nbytes)
