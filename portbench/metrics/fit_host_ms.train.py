"""Milliseconds a fit spends outside its epochs: the benchmark's clock
around each ``fit`` minus the sum of that fit's ``epoch_log`` seconds (the
epochs on the card's timeline), averaged over the window's fits.  The
fit's own set-up (epoch tables, step functions, optimizer states) and its
host transfers land here."""
import numpy as np


def read(run):
    fits = run.inputs.get('fits')
    if not fits:
        return None
    return float(np.mean([(f['end'] - f['start']) - sum(e['seconds'] for e in f['log'])
                          for f in fits])) * 1e3
