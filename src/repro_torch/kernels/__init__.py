"""Hand-written CUDA kernels for Hopper, their wrappers and their plain
PyTorch versions.  Nothing is built or launched at import time."""
