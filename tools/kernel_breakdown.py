"""Where the time of the two redesigned kernels goes, on a CUDA card.

``ncu`` does not run where the port is measured, so this script takes each
kernel's source apart instead: it builds variants of
``collie_tpu_torch/csrc/topk_tile.cu`` and ``gather_scatter.cu`` with one
part of the work removed (their outputs are then wrong; only the base
variants are checked against the plain versions) and times each at the
shapes ``chip_smoke.py`` uses.  The differences between variants are the
cost of the parts.

    python3 tools/kernel_breakdown.py [topk] [gather_scatter]

Top-k variants at the serving shape (B = 256, 2,000,000 items, D = 64,
k = 1 and 10): ``base``; ``noscan`` (no running top-k: the scores are
written, nobody folds them in); ``noepi`` (no score
tile, no flags, no scan: scoring, staging and barriers); ``nostage`` (also
no item staging: the FMAs run on whatever the buffers hold); ``nosync``
(also no barrier a stage).  Gather/scatter variants at the microbench's
shape, 50 rounds and 0 rounds: ``base``; ``no_gather``; ``no_scatter``;
``syncs_only`` (the two cluster barriers a round and nothing else).
Prints one line a variant, then one JSON object with every time.
"""
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from collie_tpu_torch.ops.kernels import _build  # noqa: E402
from collie_tpu_torch.ops.kernels.gather_scatter import binned_gather_scatter_plain  # noqa: E402
from collie_tpu_torch.ops.kernels.retrieval_kernel import topk_plan, topk_tiles_plain  # noqa: E402

BUILD = _build.BUILD_DIR / 'variants'


def replace(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f'kernel_breakdown: the source no longer holds {old!r}')
    return text.replace(old, new)


def build(name: str, text: str, flags=()) -> ctypes.CDLL:
    BUILD.mkdir(parents=True, exist_ok=True)
    source = BUILD / f'{name}.cu'
    source.write_text(text)
    lib = BUILD / f'lib{name}.so'
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, '-I', str(_build.CSRC),
                           '-o', str(lib), str(source)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'kernel_breakdown: nvcc failed on {name}:\n{proc.stderr[-3000:]}')
    return ctypes.CDLL(str(lib))


def topk_variants() -> dict:
    src = (_build.CSRC / 'topk_tile.cu').read_text()
    end = "  // the range's candidates; entries no item filled"
    alive = ('  if (p.B < 0) {  // keeps the FMAs of variants without an epilogue\n'
             '    float t = 0.f;\n'
             '    for (int i = 0; i < kMicro; ++i)\n'
             '      for (int j = 0; j < kMicro; ++j) t += acc[i][j];\n'
             '    p.out_scores[tid] = t;\n'
             '  }\n')
    noepi = replace(replace(src, '    const bool last = c == n_dim_chunks - 1;',
                            '    const bool last = false;'), end, alive + end)
    # the three lines that wait for, move and issue the copies of a stage
    start = src.index('    cp_async_wait_1();\n    if (s + 1 < total) move(s + 1);')
    stop = src.index('\n', src.index('issue(s + 3);', start)) + 1
    nostage = replace(noepi, src[start:stop], '')
    return {'base': src,
            'noscan': replace(src, '    if (!last) continue;\n', '    continue;\n'),
            'noepi': noepi, 'nostage': nostage,
            'nosync': replace(nostage, '    __syncthreads();  // stage s + 1 is in place; the '
                                       'scores are complete\n', '')}


def time_topk() -> dict:
    B, D, I = cs.REQUEST_USERS, cs.EMBEDDING_DIM, cs.NUM_ITEMS
    rng = np.random.default_rng(11)
    ue, ie, ib = cs._rand(rng, (B, D)), cs._rand(rng, (I, D)), cs._rand(rng, (I,))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    times = {}
    for name, text in topk_variants().items():
        lib = build(f'topk_{name}', text)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.collie_topk_tile.argtypes = [p, p, p] + [i] * 6 + [p] * 5
        row = {}
        for k in (1, 10):
            plan = topk_plan(B, D, k, I, sms)
            out_s = torch.empty((plan.n_ranges, B, k), device='cuda')
            out_i = torch.empty((plan.n_ranges, B, k), dtype=torch.int32, device='cuda')

            def call():
                err = lib.collie_topk_tile(
                    ue.data_ptr(), ie.data_ptr(), ib.data_ptr(), B, D, I, k, plan.user_chunk,
                    plan.tiles_per_range, None, None, out_s.data_ptr(), out_i.data_ptr(),
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise SystemExit(f'kernel_breakdown: topk {name} launch failed ({err})')

            call()
            torch.cuda.synchronize()
            if name == 'base':
                ref_s, _ = topk_tiles_plain(ue, ie, ib, k, plan.range_width)
                if not torch.allclose(out_s, ref_s, rtol=cs.RTOL, atol=cs.ATOL):
                    raise SystemExit('kernel_breakdown: the base top-k differs from its plain '
                                     'version')
            row[f'k={k}'] = cs.cuda_median_ms(call, warmup=2, runs=9)
        times[name] = row
        print(f'topk {name}: ' + ', '.join(f'{key} {ms:.4f} ms' for key, ms in row.items()),
              flush=True)
    return times


def time_gather_scatter() -> dict:
    src = (_build.CSRC / 'gather_scatter.cu').read_text()
    src = replace(src, "      // gather: every kept example's row as it stood at the start of "
                       "the round\n      for", '      if (!SKIP_GATHER) for')
    src = replace(src, '      // scatter-add the gradient columns\n      for',
                  '      if (!SKIP_SCATTER) for')
    (tab_t, sids, offs, g_t), _ = cs.gather_scatter_inputs(0, **cs.GS_SHAPE)
    D, upad = tab_t.shape
    B, n_bins = sids.shape[0], offs.shape[0] - 1
    iters, c_pad = cs.GS_SHAPE['iters'], cs.GS_SHAPE['c_pad']
    ref_out, _ = binned_gather_scatter_plain(tab_t, sids, offs, g_t, iters, c_pad)
    times = {}
    for name, skip in (('base', (0, 0)), ('no_gather', (1, 0)), ('no_scatter', (0, 1)),
                       ('syncs_only', (1, 1))):
        lib = build(f'gather_scatter_{name}', src,
                    (f'-DSKIP_GATHER={skip[0]}', f'-DSKIP_SCATTER={skip[1]}'))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.collie_binned_gather_scatter.argtypes = [p] * 6 + [i] * 6 + [p, p]

        def call(rounds):
            out = torch.empty_like(tab_t)
            gathered = torch.zeros((rounds, D), device='cuda')
            launched = (ctypes.c_int * 3)()
            err = lib.collie_binned_gather_scatter(
                tab_t.data_ptr(), sids.data_ptr(), offs.data_ptr(), g_t.data_ptr(),
                out.data_ptr(), gathered.data_ptr(), D, upad, B, n_bins, rounds, c_pad,
                ctypes.addressof(launched), torch.cuda.current_stream().cuda_stream)
            if err:
                raise SystemExit(f'kernel_breakdown: gather/scatter {name} launch failed '
                                 f'({err})')
            return out

        out = call(iters)
        torch.cuda.synchronize()
        if name == 'base' and float((out - ref_out).abs().max()) > \
                cs.GS_ATOL_SCALE * float(ref_out.abs().max()):
            raise SystemExit('kernel_breakdown: the base gather/scatter differs from its plain '
                             'version')
        full = cs.cuda_median_ms(lambda: call(iters), warmup=2, runs=11)
        none = cs.cuda_median_ms(lambda: call(0), warmup=2, runs=11)
        times[name] = {'ms': full, 'no_rounds_ms': none, 'round_us': (full - none) / iters * 1e3}
        print(f'gather_scatter {name}: {iters} rounds {full:.4f} ms, 0 rounds {none:.4f} ms, '
              f'{times[name]["round_us"]:.2f} us a round', flush=True)
    return times


def main():
    if not torch.cuda.is_available():
        raise SystemExit('kernel_breakdown: needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    which = sys.argv[1:] or ['topk', 'gather_scatter']
    print(cs.nvidia_smi(), flush=True)
    result = {}
    if 'topk' in which:
        result['topk'] = time_topk()
    if 'gather_scatter' in which:
        result['gather_scatter'] = time_gather_scatter()
    print(json.dumps(result))


if __name__ == '__main__':
    os.chdir(ROOT)
    main()
