"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
NVIDIA H100: a harness driven by the files beside it.  See README.md."""
