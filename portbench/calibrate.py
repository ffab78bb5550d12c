"""Readings that the limits of ``limits/<cell>.json`` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 5] [--out FILE]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, then its output check with the control (the reference in
the program's place, one precision step below the configuration's) and
the planted faults beside the program's readings.  Prints one JSON line a
seed (also appended to ``--out``).  Not part of a benchmark run.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seeds', required=True)
    parser.add_argument('--seconds', type=float, default=5.0)
    parser.add_argument('--out')
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    from portbench import harness, spec as spec_lib
    harness.cache_environment(ROOT)
    import torch

    spec = spec_lib.load_spec(ROOT)
    cell = spec_lib.workload(spec, args.workload)
    config = spec_lib.config_file(spec, cell['config'], ROOT)
    traffic = spec_lib.traffic_file(cell['traffic'], ROOT)
    driver = spec_lib.driver_module(traffic['driver'], ROOT)
    if not torch.cuda.is_available():
        print('calibrate: no CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    for seed in (int(s) for s in args.seeds.split(',')):
        start = time.perf_counter()
        run = driver.Cell(config, traffic, seed, device)
        run.setup()
        run.window(args.seconds)
        run.free_program()
        numbers = run.check(controls=True)
        line = {'workload': cell['name'], 'seed': seed, 'numbers': numbers,
                'seconds': time.perf_counter() - start, 'notes': run.notes()}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, 'a') as f:
                f.write(json.dumps(line) + '\n')
        del run
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
