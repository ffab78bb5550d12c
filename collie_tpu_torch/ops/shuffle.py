"""O(n) elementwise epoch shuffle: a cycle-walked Feistel bijection.

Port of ``collie_tpu/ops/shuffle.py`` (``_mix`` at ``:25``,
``feistel_permutation`` at ``:36``), bit-exact: given the same four keys it
gives the same permutation.  A 4-round Feistel network over the index bits is
a keyed bijection on ``[0, 2^bits)``; cycle-walking (re-encrypt every value
that lands at or above ``n``) restricts it to a bijection on ``[0, n)``.

The JAX version computes in uint32 and cycle-walks inside one
``lax.while_loop`` on the device.  On a CUDA tensor
``feistel_permutation_from_keys`` launches the hand-written kernel
``collie_tpu_torch/csrc/shuffle.cu`` (one thread per index, each walking in
registers; no host sync) and raises if it cannot; it runs the plain version
``feistel_permutation_plain`` only for keys that lie on the CPU.
``feistel_permutation_from_keys.launches`` counts kernel launches.  Both give
the permutation as int32.

The plain version is the whole-array loop: re-encrypt every out-of-range
value until none is left, which asks the host after each pass.  PyTorch's
uint32 arithmetic is limited, so there every value is an int64 holding a
uint32, masked to 32 bits after each add and multiply; a 32-bit by 32-bit
product is split into 16-bit halves so no intermediate leaves int64's range.
"""
import ctypes
from typing import Optional

import torch

from collie_tpu_torch.ops.kernels import _build

SOURCE = 'shuffle.cu'
ABI = 1

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


def _check_keys(keys: torch.Tensor, n: int) -> None:
    if keys.shape != (4,):
        raise ValueError(f'feistel_permutation takes 4 keys, got shape {tuple(keys.shape)}')
    if not 2 <= n < 2 ** 31:
        raise ValueError(f'feistel_permutation takes 2 <= n < 2^31, got {n}')


def feistel_permutation_plain(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The whole-array cycle-walk in int64 arithmetic, on the keys' device;
    the kernel's reference.  Int32."""
    _check_keys(keys, n)
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
            return e.to(torch.int32)
        e = torch.where(out, encrypt(e), e)


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, abi=('collie_shuffle_abi', ABI))
    p = ctypes.c_void_p
    lib.collie_feistel_cycle_walk.argtypes = [p, ctypes.c_int, p, p]
    lib.collie_feistel_cycle_walk.restype = ctypes.c_int
    return lib


def _on_card(keys: torch.Tensor) -> bool:
    return keys.device.type == 'cuda'


def feistel_permutation_cuda(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the cycle-walk kernel on the current stream: int32 ``[n]`` on
    the keys' device.  Reads nothing back from the card."""
    _check_keys(keys, n)
    if not _on_card(keys):
        raise ValueError('feistel_permutation_cuda takes CUDA keys')
    lib = _library()
    keys = keys.to(torch.int64).contiguous()
    out = torch.empty(n, dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        stream = torch.cuda.current_stream(keys.device).cuda_stream
        err = lib.collie_feistel_cycle_walk(keys.data_ptr(), n, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f'collie_feistel_cycle_walk launch failed: cudaError_t {err}')
    feistel_permutation_from_keys.launches += 1
    return out


def feistel_permutation_from_keys(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The permutation of ``arange(n)`` under four keys in ``[0, 2^31 - 1)``
    (the values the JAX version draws at ``shuffle.py:50-51``), on the keys'
    device, as int32: the kernel for CUDA keys, the plain version for CPU
    keys."""
    if _on_card(keys):
        return feistel_permutation_cuda(keys, n)
    if keys.device.type == 'cpu':
        return feistel_permutation_plain(keys, n)
    raise ValueError(f'feistel_permutation runs on cuda or cpu, not {keys.device}')


feistel_permutation_from_keys.launches = 0


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
