"""How often ``chip_smoke.py`` phase 8(d)'s resume check holds, on a CUDA
card.

The check fits the ML-10M-scale configuration for five epochs with a
checkpoint each epoch, resumes a fresh model from the epoch-3 checkpoint,
and holds the resumed epoch 4 against the uninterrupted one at the epoch
kernels' tolerance (``chip_smoke.compare_epoch``, at most
``MAX_FLIPPED_FRACTION`` of elements beyond).  Both launches start from the
same state, so what parts them is the kernels' run-dependent summation
order.  This script runs ``chip_smoke.check_resume`` ``--repeats`` times on
one card and prints, for each trial, the uninterrupted fit's losses and
learning rates, then whether the check held.

    python3 tools/resume_repeatability.py [--repeats 4]

Prints the card's name and power limit, and last one JSON object with the
trials' outcomes.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--repeats', type=int, default=4)
    args = parser.parse_args(argv)
    smi = cs.phase_device()
    cs.phase_build()
    ml10m = cs.ml10m_data()['implicit']
    sub = cs.ml10m_eval_users(ml10m[2])
    checked = cs._check_resumed

    def traced(label, whole, resumed, first, last, explicit):
        cs.log(f'  {label}: losses {[round(whole[e]["loss"], 5) for e in sorted(whole)]}, '
               f'lr after each epoch '
               f'{[whole[e]["opt_states"][0].learning_rate for e in sorted(whole)]}')
        return checked(label, whole, resumed, first, last, explicit)

    cs._check_resumed = traced
    trials = []
    for trial in range(args.repeats):
        start = time.perf_counter()
        try:
            cs.check_resume(ml10m, sub, smi)
            outcome = 'held'
        except AssertionError as err:
            outcome = f'failed: {err}'
        cs.log(f'trial {trial}: {outcome} ({time.perf_counter() - start:.1f}s)')
        trials.append(outcome)
    print(smi)
    print(json.dumps({'resume_trials': trials,
                      'failed': sum(t != 'held' for t in trials)}))


if __name__ == '__main__':
    main()
