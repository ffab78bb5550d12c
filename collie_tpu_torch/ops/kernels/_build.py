"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source has a plain C interface and is compiled with
``nvcc`` into its own shared library, loaded with ``ctypes``: a build takes
seconds, where a source that includes PyTorch's headers takes minutes.  The
library goes into ``collie_tpu_torch/csrc/build/`` (listed in ``.gitignore``)
under a name that carries a hash of the source and the flags, so an edited
source is rebuilt and an unchanged one is loaded as it is.  Nothing here runs
at import time.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = CSRC / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
#: ``{source name: (seconds, ptxas report)}`` of the builds this process ran
build_log: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the toolkit's
    default location."""
    cuda_home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if cuda_home:
        return str(Path(cuda_home) / 'bin' / 'nvcc')
    return shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'


def library_path(source: str) -> Path:
    """Where the library for ``csrc/<source>`` lives once built."""
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha1(text + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f'lib{Path(source).stem}_{digest}.so'


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library already exists."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent build never sees
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd: List[str] = [nvcc_path(), *NVCC_FLAGS, '-o', tmp, str(CSRC / source)]
    start = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f'nvcc failed on {source} (exit {proc.returncode}):\n'
                f'{" ".join(cmd)}\n{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_log[source] = (time.perf_counter() - start, proc.stdout + proc.stderr)
    return out


def load(source: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<source>``; one load per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
