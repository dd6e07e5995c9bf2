"""Set-up: from the process's start to the window's (imports, the CUDA
context, loading or building the kernels, the weights, the cache, the
warm-up of the cell's own shapes), on the host clock."""


def read(rec):
    return rec.setup_s
