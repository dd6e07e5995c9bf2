"""Python wrapper for the exact three-way bfloat16 split of a float32
matrix, a CUDA kernel for Hopper (``csrc/bf16_split.cu``).

It replaces no TPU kernel: the head's backward
(:class:`repro_torch.models.layers.HeadProduct`) splits the float32
cotangent of the logits into three bf16 pieces that sum to it exactly, so
the cotangent meets the bf16 head on the tensor cores unrounded.  The
source comment says why the sum is exact, what bounds the kernel on the
H100 and what its design does about it.  This wrapper checks its argument,
allocates the pieces, launches the kernel on PyTorch's current stream and
raises if the launch fails.  It takes CUDA tensors only: other tensors go to
the plain version through :func:`repro_torch.kernels.ops.split_bf16`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import load

__all__ = ["bf16_split"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("bf16_split")
    fn = lib.bf16_split3
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.bf16_split3_error_string.argtypes = [ctypes.c_int]
    lib.bf16_split3_error_string.restype = ctypes.c_char_p
    return lib


def bf16_split(g: torch.Tensor) -> torch.Tensor:
    """Launch the split.  ``g`` ``(rows, cols)`` float32 on a CUDA device
    with unit stride along its columns (a column block of a wider matrix
    will do).  Returns ``(rows, 3, cols)`` bfloat16, contiguous: each row's
    ``hi``, ``mid`` and ``lo``, whose sum is ``g`` (see
    :func:`repro_torch.kernels.ref.bf16_split_ref`).  ``bf16_split.launches``
    counts calls, one kernel each."""
    if g.device.type != "cuda":
        raise ValueError(f"bf16_split launches a CUDA kernel; got a tensor on {g.device} "
                         "(other tensors go through repro_torch.kernels.ops.split_bf16)")
    if g.dtype != torch.float32 or g.dim() != 2:
        raise TypeError(f"g must be a 2-D float32 matrix, got {g.dtype} {tuple(g.shape)}")
    rows, cols = g.shape
    if g.stride(1) != 1 or g.stride(0) < cols:
        raise ValueError(f"g's rows must be unit-stride and apart, got strides {g.stride()}")
    out = torch.empty((rows, 3, cols), dtype=torch.bfloat16, device=g.device)
    if g.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.bf16_split3(g.data_ptr(), g.stride(0), out.data_ptr(), rows, cols, stream)
    if err != 0:
        msg = lib.bf16_split3_error_string(err).decode()
        raise RuntimeError(f"bf16_split launch failed: {msg} (cudaError {err})")
    bf16_split.launches += 1
    return out


bf16_split.launches = 0
