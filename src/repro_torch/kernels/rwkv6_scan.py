"""Python wrapper for the chunked RWKV6 WKV scan, a CUDA kernel for Hopper.

The kernel (``csrc/rwkv6_scan.cu``) replaces the JAX package's Pallas TPU
kernel ``repro.kernels.rwkv6_scan.rwkv6_scan``; its source comment says what
bounds it on the H100 and how its design answers that.  This wrapper checks
its arguments, allocates the outputs and the per-chunk scratch (each chunk's
state increment and decay), launches the kernel's three passes on PyTorch's
current stream and raises if a launch fails.  It takes CUDA tensors only:
CPU tensors go to the plain version through :func:`repro_torch.kernels.ops.rwkv6`.

:func:`rwkv6_scan_trainable` is the counterpart of the JAX
``rwkv6_scan_trainable``: its forward is ``ops.rwkv6`` (on the card, the
kernel) and its backward recomputes the recurrence through
:func:`repro_torch.kernels.ref.rwkv6_ref` and differentiates it, the JAX
package's own oracle backward.  There is no backward kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from .build import load
from .ref import rwkv6_ref

__all__ = ["rwkv6_scan", "rwkv6_scan_trainable", "check_rwkv6_args", "chunk_for",
           "kernel_chunk", "smem_bytes", "KERNELS_PER_CALL"]

_SUPPORTED_N = (32, 64)
KERNELS_PER_CALL = 3    # the state, carry and output passes


def chunk_for(T: int) -> int:
    """Chunk length for a sequence of ``T`` tokens: 64 where it divides T,
    else 16 with a masked ragged last chunk (the JAX model's rule).  The
    CUDA kernel takes its own chunk length for every T, with a masked
    ragged last chunk: the same function."""
    return 64 if T % 64 == 0 else 16


def check_rwkv6_args(r, k, v, w, u, S0) -> None:
    """Raise on any argument the kernel does not take: shapes, dtypes,
    contiguity, alignment and devices."""
    if r.dim() != 4:
        raise ValueError(f"r must be (B, T, H, N), got {tuple(r.shape)}")
    B, T, H, N = r.shape
    if T < 1:
        raise ValueError("T must be >= 1")
    if N not in _SUPPORTED_N:
        raise ValueError(f"head size N={N} not in {_SUPPORTED_N}")
    for name, a in (("k", k), ("v", v), ("w", w)):
        if tuple(a.shape) != (B, T, H, N):
            raise ValueError(f"{name} must be {(B, T, H, N)}, got {tuple(a.shape)}")
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u must be {(H, N)}, got {tuple(u.shape)}")
    if tuple(S0.shape) != (B, H, N, N):
        raise ValueError(f"S0 must be {(B, H, N, N)}, got {tuple(S0.shape)}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"r must be float32 or bfloat16, got {r.dtype}")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError("r, k and v must share one dtype")
    for name, a in (("w", w), ("u", u), ("S0", S0)):
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("S0", S0)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != r.device:
            raise ValueError(f"{name} is on {a.device}, r on {r.device}")
    for name, a in (("r", r), ("k", k), ("v", v), ("w", w)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("rwkv6_scan")
    fn = lib.rwkv6_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.rwkv6_scan_error_string.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_error_string.restype = ctypes.c_char_p
    lib.rwkv6_scan_smem_bytes.argtypes = [ctypes.c_int]
    lib.rwkv6_scan_smem_bytes.restype = ctypes.c_int
    lib.rwkv6_scan_chunk.argtypes = []
    lib.rwkv6_scan_chunk.restype = ctypes.c_int
    return lib


def smem_bytes(N: int) -> int:
    """Dynamic shared memory one block of the kernel's output pass (its
    largest) takes at head size ``N`` (builds the kernel if needed)."""
    n = _lib().rwkv6_scan_smem_bytes(N)
    if n < 0:
        raise ValueError(f"no kernel built for N={N}")
    return n


def kernel_chunk() -> int:
    """Tokens a chunk of the CUDA kernel, the same for every T (builds the
    kernel if needed)."""
    return _lib().rwkv6_scan_chunk()


def rwkv6_scan(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the WKV kernel.  r, k, v ``(B,T,H,N)`` float32 or bfloat16;
    w ``(B,T,H,N)``, u ``(H,N)`` and S0 ``(B,H,N,N)`` float32, all contiguous
    on one CUDA device, any ``T >= 1``.  Returns ``(y (B,T,H,N) in r's dtype,
    S_T (B,H,N,N) float32)``.  ``rwkv6_scan.launches`` counts calls, each
    of which launches the kernel's ``KERNELS_PER_CALL`` passes."""
    check_rwkv6_args(r, k, v, w, u, S0)
    if r.device.type != "cuda":
        raise ValueError(
            f"rwkv6_scan launches a CUDA kernel; got tensors on {r.device} "
            "(CPU tensors go through repro_torch.kernels.ops.rwkv6)"
        )
    B, T, H, N = r.shape
    lib = _lib()
    nch = -(-T // kernel_chunk())
    y = torch.empty_like(r)
    sT = torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)
    ds = torch.empty((B, H, nch, N, N), dtype=torch.float32, device=r.device)
    decay = torch.empty((B, H, nch, N), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv6_scan_fwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), S0.data_ptr(), y.data_ptr(), sT.data_ptr(),
            ds.data_ptr(), decay.data_ptr(), B, T, H, N,
            int(r.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.rwkv6_scan_error_string(err).decode()
        raise RuntimeError(f"rwkv6_scan launch failed: {msg} (cudaError {err})")
    rwkv6_scan.launches += 1
    return y, sT


rwkv6_scan.launches = 0


class _Rwkv6Scan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, S0):
        from .ops import rwkv6

        ctx.save_for_backward(r, k, v, w, u, S0)
        return rwkv6(r, k, v, w, u, S0)

    @staticmethod
    def backward(ctx, gy, gs):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y, sT = rwkv6_ref(*leaves)
            return torch.autograd.grad((y, sT), leaves, (gy, gs), allow_unused=True)


def rwkv6_scan_trainable(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
    u: torch.Tensor, S0: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV recurrence through ``ops.rwkv6`` with the oracle backward
    (recompute through ``rwkv6_ref`` and differentiate it)."""
    return _Rwkv6Scan.apply(r, k, v, w, u, S0)
