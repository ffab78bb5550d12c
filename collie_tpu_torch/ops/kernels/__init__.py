"""Hand-written CUDA kernels (``collie_tpu_torch/csrc``) with their plain
PyTorch versions and launch counters."""
