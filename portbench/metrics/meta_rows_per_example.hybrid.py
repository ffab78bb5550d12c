"""Metadata rows the model gathers a training example of the metadata
stages: the program counter ``collie.hybrid.metadata_rows`` over the traced
window (every row of each gather, a batch's pad rows included) over the
examples of the window's ``metadata_only`` and ``all`` epochs.  The code
as it stands gathers K + 2 rows an example: the selection's K and the
positive and hardest negative scored again.  A program without the
counter reads None."""
from portbench.metrics._counts_hybrid import MF_STAGE


def read(run):
    rows = (run.inputs.get('counts') or {}).get('collie.hybrid.metadata_rows')
    fits = run.inputs.get('fits')
    if not rows or not fits:
        return None
    epochs = sum(len(f['log']) for f in fits if f['stage'] != MF_STAGE)
    if epochs == 0:
        return None
    return rows / (epochs * run.inputs['shape']['examples'])
