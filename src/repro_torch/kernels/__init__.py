"""Hand-written CUDA kernels of the port (``csrc/*.cu``) with their
wrappers, plain PyTorch versions and launch counters; see ``ops``."""
