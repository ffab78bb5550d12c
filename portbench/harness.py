"""One run of one cell: set-up, the measured window, the output check, and
the result line.

The result is the last line of standard output, one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and with
``--trace 1`` ``breakdown``), and last ``checks``: each compared number
beside its limit, which also close standard error.  With ``--trace 0`` the
metrics are the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, read by ``metrics/<name>.py`` from what the cell's driver module
recorded and from the trace.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

from portbench import spec as spec_lib
from portbench.device import sync

#: top-level module names that may not be loaded in a run
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'collie_tpu')


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name, compared whole, is forbidden:
    ``collie_tpu_torch`` is allowed, ``collie_tpu.ops`` is not."""
    names = sys.modules if modules is None else modules
    return sorted({m.split('.', 1)[0] for m in names if m.split('.', 1)[0] in FORBIDDEN})


def cache_environment(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = root / '.portbench_cache'
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['USE_FLAX'] = '0'


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


class Run:
    """What a metric reader sees: the cell's records and the trace."""

    def __init__(self, inputs: dict, trace):
        self.inputs, self.trace = inputs, trace


def parse(argv: List[str]) -> argparse.Namespace:
    parser = argparse.ArgumentParser(prog='portbench/run.py')
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


def judge(numbers: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each compared number with its limit; a number the limits file does
    not name is a fault of the benchmark, not a pass."""
    out = {}
    for name, value in numbers.items():
        if '.' in name:                 # control and fault readings: calibration only
            continue
        if name not in limits['numbers']:
            raise KeyError(f'no limit for {name}')
        out[name] = {'value': value, 'limit': limits['numbers'][name]['limit']}
    return out


def main(argv: List[str], t_start: float, root: Path = spec_lib.ROOT,
         device=None) -> int:
    """One run; ``device`` given (the tests' CPU) skips the look for cards."""
    args = parse(argv)
    spec = spec_lib.load_spec(root)
    cell = spec_lib.workload(spec, args.workload)
    config = spec_lib.config_file(spec, cell['config'], root)
    traffic = spec_lib.traffic_file(cell['traffic'], root)
    limits = spec_lib.limits_file(cell['name'], root)
    driver = spec_lib.driver_module(traffic['driver'], root)

    import torch
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
            print(f'portbench: {cell["name"]} needs {cell["chips"]} CUDA card(s), found '
                  f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
                  file=sys.stderr)
            return 2
        device = torch.device('cuda', 0)
    on_card = device.type == 'cuda'
    card = power_limit() if on_card else None
    print(f'portbench: {cell["name"]} seed {args.seed} on {card}', file=sys.stderr)

    run = driver.Cell(config, traffic, args.seed, device)
    run.setup()
    sync(device)
    setup_s = time.perf_counter() - t_start

    trace = None
    if args.trace:
        from portbench.tracing import Tracer
        with Tracer() as tracer:
            with torch.profiler.record_function('portbench.window'):
                run.window(args.seconds, traced=True)
        trace = tracer.summary
    else:
        run.window(args.seconds)
    sync(device)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    for note in run.notes():
        print(f'portbench: {note}', file=sys.stderr)

    if args.trace:
        metrics = {}
        layer_run = Run(run.layer_inputs(), trace)
        for m in spec_lib.per_layer_for(spec, cell['name']):
            value = spec_lib.metric_module(m['name'], root).read(layer_run)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    else:
        measured = {**run.end_to_end(), 'setup_s': setup_s}
        metrics = {m['name']: {'value': measured[m['name']], 'unit': m['unit']}
                   for m in spec_lib.end_to_end_for(spec, cell['name'])}

    run.free_program()
    checks = judge(run.check(), limits)
    found = forbidden_modules()
    if found:
        print(f'portbench: forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    correct = run.failed == 0 and all(c['value'] <= c['limit'] for c in checks.values())
    device_info = {'platform': 'gpu' if on_card else 'cpu',
                   'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
                   'count': cell['chips'], 'memory_peak_bytes': int(peak),
                   'power': card}
    result = {'correct': correct, 'attempted': run.attempted, 'failed': run.failed,
              'metrics': metrics, 'device': device_info}
    if trace is not None:
        device_info.update(busy_s=trace.busy_s, window_s=trace.window_s)
        result['breakdown'] = trace.breakdown()
    result['checks'] = checks
    print(f'portbench: setup_s {setup_s!r}', file=sys.stderr)
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
