"""Binned gather and scatter-add of embedding rows: the kernel and its plain
twin.

Port of the Pallas TPU kernel ``pk`` in ``benchmarks/microbench_gather.py``
(``:151``, launched by ``pallas_binned`` at ``:185-201``), the experiment
that measured the cost of gathering and scatter-adding embedding rows at the
ML-10M user-table shape.  The CUDA kernel is
``collie_tpu_torch/csrc/gather_scatter.cu`` (see its header for the design
and the bound): one thread-block cluster per bin, the bin's rows in the
cluster's distributed shared memory, or in device memory where they do not
fit (``gather_scatter_plan`` says which).

The layout is the microbench's: a transposed table ``tab_t [D, UPAD]``
(``UPAD = n_bins * UB``), ids ``sids [B]`` stably sorted by bin
(``sids // UB``), bin offsets ``offs [n_bins + 1]`` and gradient columns
``g_t [D, B]`` in the sorted order.  Each of ``iters`` rounds gathers every
kept example's row, as the table stood at the start of the round, and then
adds its gradient column to that row.  An example at sorted position ``p``
in bin ``j`` is kept when ``p - offs[j] < c_pad`` (the TPU kernel's window of
``c_pad`` positions per bin) and its id lies in bin ``j``.  Returns ``out
[D, UPAD]`` and ``gathered [iters, D]``, the per-round sum of the gathered
rows.

The TPU kernel reads its window with ``pl.ds(offs[j], c_pad)``, which runs
past the arrays for the last bins when ``offs[j] + c_pad > B``; there its
values are undefined on the TPU, and interpret mode clamps the slice start
so ids and positions no longer line up.  Here every kept example counts and
nothing past ``B`` is read: the semantics of the TPU kernel run on inputs
padded by ``c_pad`` masked entries.

``binned_gather_scatter`` launches the kernel for CUDA tensors and raises on
anything it does not take; it runs ``binned_gather_scatter_plain`` only for
tensors that lie on the CPU.  ``binned_gather_scatter.launches`` counts
kernel launches and ``binned_gather_scatter.last_plan`` is the plan the
last launch reported.
"""
import ctypes
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from collie_tpu_torch.ops.kernels import _build

SOURCE = 'gather_scatter.cu'

MAX_CLUSTER = 8                # the portable cluster size
TARGET_BYTES = 98304           # the smallest cluster whose blocks stay under this
MAX_SHARED_BYTES = 232448      # what one block may use on sm_90


@dataclass(frozen=True)
class GatherScatterPlan:
    """One launch: ``cluster`` blocks a bin; the bin's rows in the
    cluster's shared memory (``shared_rows``) or in ``out``; each block's
    share of examples cached in shared memory (``cache``) or read from
    device memory every round."""
    shared_rows: bool
    cache: bool
    cluster: int
    shared_bytes: int

    @property
    def mode(self) -> str:
        return 'shared rows' if self.shared_rows else 'device rows'


def gather_scatter_plan(D: int, upad: int, n_bins: int, B: int,
                        c_pad: int) -> GatherScatterPlan:
    """The kernel's plan (``make_plan`` in csrc/gather_scatter.cu): the
    smallest cluster of 1, 2, 4, 8 blocks whose share of a bin's rows (rows
    of ``D | 1`` floats) and of its window of examples stays under 96 KB a
    block, else 8; rows and cache in shared memory where they fit 227 KB,
    else the cache alone, else neither."""
    ub = upad // n_bins
    stride = D | 1
    window = min(c_pad, B)
    sums = 4 * D

    def rows(cs):
        return 4 * -(-ub // cs) * stride

    def cache(cs):
        return 4 * -(-window // cs) * (stride + 1)

    cs = 1
    while cs < MAX_CLUSTER and rows(cs) + cache(cs) + sums > TARGET_BYTES:
        cs *= 2
    if rows(cs) + cache(cs) + sums <= MAX_SHARED_BYTES:
        shared_rows, use_cache = True, True
    elif rows(cs) + sums <= MAX_SHARED_BYTES:
        shared_rows, use_cache = True, False
    else:
        shared_rows, use_cache = False, cache(cs) + sums <= MAX_SHARED_BYTES
    nbytes = sums + (rows(cs) if shared_rows else 0) + (cache(cs) if use_cache else 0)
    return GatherScatterPlan(shared_rows, use_cache, cs, nbytes)


def _check_inputs(tab_t, sids, offs, g_t, iters, c_pad) -> Tuple[int, int, int, int]:
    tensors = (tab_t, sids, offs, g_t)
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f'binned_gather_scatter: inputs on several devices {devices}')
    if tab_t.dtype != torch.float32 or g_t.dtype != torch.float32:
        raise TypeError('binned_gather_scatter: tab_t and g_t must be float32, got '
                        f'{tab_t.dtype} and {g_t.dtype}')
    if sids.dtype != torch.int32 or offs.dtype != torch.int32:
        raise TypeError('binned_gather_scatter: sids and offs must be int32, got '
                        f'{sids.dtype} and {offs.dtype}')
    if tab_t.dim() != 2 or sids.dim() != 1 or offs.dim() != 1 or g_t.dim() != 2:
        raise ValueError('binned_gather_scatter: tab_t [D, UPAD], sids [B], offs '
                         '[n_bins + 1] and g_t [D, B]')
    D, upad = tab_t.shape
    B = sids.shape[0]
    n_bins = offs.shape[0] - 1
    if tuple(g_t.shape) != (D, B):
        raise ValueError(f'g_t must be [D, B] = {(D, B)}, got {tuple(g_t.shape)}')
    if D < 1 or B < 1 or n_bins < 1 or upad % n_bins:
        raise ValueError(f'binned_gather_scatter: D={D} B={B} n_bins={n_bins} and UPAD={upad} '
                         'must be positive, with UPAD a multiple of n_bins')
    if int(iters) < 0 or int(c_pad) < 0:
        raise ValueError(f'iters and c_pad must be >= 0, got {iters} and {c_pad}')
    return D, upad, B, n_bins


def kept_examples(sids, offs, upad: int, c_pad: int) -> torch.Tensor:
    """``[B]`` bool: the sorted positions the bin windows keep."""
    B = sids.shape[0]
    n_bins = offs.shape[0] - 1
    ub = upad // n_bins
    pos = torch.arange(B, device=sids.device)
    offs = offs.long()
    j = torch.searchsorted(offs[1:], pos, right=True)        # the last j with offs[j] <= pos
    in_range = j < n_bins
    j = j.clamp(max=n_bins - 1)
    local = sids.long() - j * ub
    return in_range & (pos - offs[j] < c_pad) & (local >= 0) & (local < ub)


def binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters: int,
                                c_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch ``binned_gather_scatter``: a loop over rounds, one
    ``index_select`` and one ``index_add_`` each.  Used for CPU tensors and
    as the kernel's reference."""
    D, upad, _, _ = _check_inputs(tab_t, sids, offs, g_t, iters, c_pad)
    kept = kept_examples(sids, offs, upad, int(c_pad))
    ids = sids.long()[kept]
    g = g_t[:, kept]
    out = tab_t.clone()
    gathered = torch.empty((int(iters), D), dtype=torch.float32, device=tab_t.device)
    for t in range(int(iters)):
        gathered[t] = out.index_select(1, ids).sum(dim=1)
        out.index_add_(1, ids, g)
    return out, gathered


def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    # pointers and the stream as c_void_p: ctypes would cut a bare int to 32 bits
    lib.collie_binned_gather_scatter.argtypes = [p] * 6 + [i] * 6 + [p, p]
    lib.collie_binned_gather_scatter.restype = i
    lib.collie_gather_scatter_plan.argtypes = [i] * 5 + [p] * 3
    lib.collie_gather_scatter_plan.restype = ctypes.c_longlong
    return lib


def kernel_plan(D: int, upad: int, n_bins: int, B: int, c_pad: int) -> GatherScatterPlan:
    """The plan as the built kernel computes it (for holding
    ``gather_scatter_plan`` to it on the card)."""
    flags = (ctypes.c_int * 3)()
    nbytes = _library().collie_gather_scatter_plan(
        D, upad, n_bins, B, c_pad, ctypes.addressof(flags), ctypes.addressof(flags) + 4,
        ctypes.addressof(flags) + 8)
    if nbytes < 0:
        raise ValueError('collie_gather_scatter_plan: shapes the kernel does not take')
    return GatherScatterPlan(bool(flags[0]), bool(flags[1]), flags[2], nbytes)


def binned_gather_scatter_cuda(tab_t, sids, offs, g_t, iters: int,
                               c_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on the current stream."""
    D, upad, B, n_bins = _check_inputs(tab_t, sids, offs, g_t, iters, c_pad)
    if tab_t.device.type != 'cuda':
        raise ValueError('binned_gather_scatter_cuda takes CUDA tensors')
    lib = _library()
    device = tab_t.device
    tab_t, sids, offs, g_t = (t.contiguous() for t in (tab_t, sids, offs, g_t))
    out = torch.empty_like(tab_t)
    gathered = torch.zeros((int(iters), D), dtype=torch.float32, device=device)
    launched = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.collie_binned_gather_scatter(
            tab_t.data_ptr(), sids.data_ptr(), offs.data_ptr(), g_t.data_ptr(), out.data_ptr(),
            gathered.data_ptr(), D, upad, B, n_bins, int(iters), int(c_pad),
            ctypes.addressof(launched), stream)
    if err != 0:
        raise RuntimeError(f'collie_binned_gather_scatter launch failed: cudaError_t {err}')
    binned_gather_scatter.launches += 1
    plan = gather_scatter_plan(D, upad, n_bins, B, int(c_pad))
    binned_gather_scatter.last_plan = GatherScatterPlan(
        bool(launched[0]), bool(launched[1]), launched[2], plan.shared_bytes)
    return out, gathered


def binned_gather_scatter(tab_t, sids, offs, g_t, iters: int,
                          c_pad: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``iters`` rounds of gathering the kept examples' rows of ``tab_t
    [D, UPAD]`` and scatter-adding ``g_t [D, B]`` into them; returns ``(out
    [D, UPAD], gathered [iters, D])``.  ``sids [B]`` int32 are stably sorted
    by bin and ``offs [n_bins + 1]`` int32 are the bin offsets.  CUDA tensors
    go through the kernel, CPU tensors through
    ``binned_gather_scatter_plain``."""
    device = tab_t.device
    if device.type == 'cpu':
        return binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters, c_pad)
    if device.type == 'cuda':
        return binned_gather_scatter_cuda(tab_t, sids, offs, g_t, iters, c_pad)
    raise ValueError(f'binned_gather_scatter runs on cuda or cpu, not {device}')


binned_gather_scatter.launches = 0
binned_gather_scatter.last_plan: Optional[GatherScatterPlan] = None
