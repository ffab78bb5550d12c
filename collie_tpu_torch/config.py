"""Global configuration for ``collie_tpu_torch``.

The single environment-driven knob of the reference: ``DATA_PATH`` points at
the directory where datasets (e.g. MovieLens 100K) are cached on the host.
"""
import os
from pathlib import Path

DATA_PATH = Path(os.environ.get('DATA_PATH', 'data'))
