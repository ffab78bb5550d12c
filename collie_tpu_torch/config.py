"""Global configuration for ``collie_tpu_torch``.

The single environment-driven knob of the reference: ``DATA_PATH`` points at
the directory where datasets (e.g. MovieLens 100K) are cached on the host.

``collie_tpu.config.enable_compilation_cache`` has no counterpart here: it
points JAX at a persistent cache of compiled XLA programs, and this package
compiles no programs at run time (its CUDA kernels are built once into
``csrc/build/`` by ``ops/kernels/_build.py``).
"""
import os
from pathlib import Path

DATA_PATH = Path(os.environ.get('DATA_PATH', 'data'))
