"""O(n) elementwise epoch shuffle: a cycle-walked Feistel bijection.

Port of ``collie_tpu/ops/shuffle.py`` (``_mix`` at ``:25``,
``feistel_permutation`` at ``:36``), bit-exact: given the same four keys it
gives the same permutation.  A 4-round Feistel network over the index bits is
a keyed bijection on ``[0, 2^bits)``; cycle-walking (re-encrypt every value
that lands at or above ``n``) restricts it to a bijection on ``[0, n)``.

The JAX version computes in uint32.  PyTorch's uint32 arithmetic is limited,
so here every value is an int64 holding a uint32, masked to 32 bits after
each add and multiply; a 32-bit by 32-bit product is split into 16-bit
halves so no intermediate leaves int64's range.
"""
from typing import Optional

import torch

_MASK32 = 0xFFFFFFFF
_KEY_HIGH = 2 ** 31 - 1          # jax.random.randint(..., 0, iinfo(int32).max)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for int64 ``x`` in ``[0, 2^32)``."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _MASK32


def _mix(x: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """murmur3-style avalanche of ``x`` under ``key`` (uint32 values in int64)."""
    h = (x + key) & _MASK32
    h = _mul32(h, 0x9E3779B9)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    return h


def feistel_permutation_from_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The permutation of ``arange(n)`` under four keys in ``[0, 2^31 - 1)``
    (the values the JAX version draws at ``shuffle.py:50-51``), on the keys'
    device, as int64."""
    assert n >= 2
    if keys.shape != (4,):
        raise ValueError(f'feistel_permutation takes 4 keys, got shape {tuple(keys.shape)}')
    keys = keys.to(torch.int64) & _MASK32
    bits = max((n - 1).bit_length(), 2)
    lo_bits = bits // 2
    hi_bits = bits - lo_bits
    lo_mask = (1 << lo_bits) - 1
    hi_mask = (1 << hi_bits) - 1

    def encrypt(x):
        lo = x & lo_mask
        hi = (x >> lo_bits) & hi_mask
        for i in range(4):
            # unbalanced Feistel: alternate which half is mixed so both
            # widths diffuse
            if i % 2 == 0:
                lo = (lo ^ _mix(hi, keys[i])) & lo_mask
            else:
                hi = (hi ^ _mix(lo, keys[i])) & hi_mask
        return (hi << lo_bits) | lo

    e = encrypt(torch.arange(n, dtype=torch.int64, device=keys.device))
    # cycle-walk: the domain is [0, 2^bits) < 2n, so each out-of-range value
    # is re-encrypted until it lands in [0, n) (as ``shuffle.py:68-74``)
    while True:
        out = e >= n
        if not bool(out.any()):
            return e
        e = torch.where(out, encrypt(e), e)


def draw_feistel_keys(generator: torch.Generator) -> torch.Tensor:
    """Four keys in ``[0, 2^31 - 1)`` from ``generator``, on its device."""
    return torch.randint(0, _KEY_HIGH, (4,), generator=generator,
                         device=generator.device, dtype=torch.int64)


def feistel_permutation(generator: torch.Generator, n: int,
                        keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A keyed bijection of ``arange(n)``: O(n) elementwise, no sort.  The
    keys come from ``generator`` unless given."""
    if keys is None:
        keys = draw_feistel_keys(generator)
    return feistel_permutation_from_keys(keys, n)
