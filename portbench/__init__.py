"""The benchmark of ``collie_tpu_torch``, the PyTorch and CUDA package.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` on the CUDA cards of this machine and
prints one JSON line.  Everything is found by name: a configuration in
``configs/<name>.json``, a traffic mix in ``traffic/<name>.json`` (which names
its driver, ``drivers/<driver>.py``), a per-layer metric in
``metrics/<name>.py`` and the limits of a cell's output check in
``limits/<cell>.json``.  The plain reference that decides ``correct`` lives
in ``reference/`` and imports nothing of the package under test.
"""
