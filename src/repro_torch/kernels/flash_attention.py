"""Python wrapper for flash attention (forward), a CUDA kernel for Hopper,
and its trainable form.

The kernels (``csrc/flash_attention.cu``) replace the JAX package's Pallas
TPU kernel ``repro.kernels.flash_attention.flash_attention``; the source
comment says what bounds them on the H100 and how the design answers that.
bfloat16 runs the tensor-core kernel (wgmma, TMA-fed K/V tiles, one K/V tile
for a whole GQA group); float32 runs the SIMT kernel in full f32.
:func:`flash_attention` checks its arguments, allocates the output, launches
on PyTorch's current stream and raises if the launch fails.  It takes
contiguous CUDA tensors only: CPU tensors go to the plain version through
:func:`repro_torch.kernels.ops.attention`.

:func:`flash_attention_trainable` is the counterpart of the JAX
``flash_attention_trainable``: its forward is ``ops.attention`` (on the card,
the kernel) and its backward recomputes attention through
:func:`repro_torch.kernels.ref.attention_ref` and differentiates it, the JAX
package's own oracle backward.  There is no backward kernel.  On meta
tensors (the dry-run) the forward counts the kernel's work by formula
(:mod:`.meta`) and the backward traces ``attention_ref``'s ops, the same
ops it runs on the card.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from .build import load
from .ref import attention_ref

__all__ = ["flash_attention", "flash_attention_trainable", "check_attention_args",
           "smem_bytes", "tile_plan", "occupancy"]

_SUPPORTED_D = (32, 64, 128, 256)
# query rows a block of the bf16 kernel owns: one warpgroup's 64
ROWS_PER_BLOCK = 64


def check_attention_args(q, k, v, window: Optional[int] = None) -> None:
    """Raise on any argument the kernel does not take: shapes, dtypes,
    contiguity, devices and the window."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, Hq, D), got {tuple(q.shape)}")
    B, S, Hq, D = q.shape
    if S < 1:
        raise ValueError("S must be >= 1")
    if D not in _SUPPORTED_D:
        raise ValueError(f"head size D={D} not in {_SUPPORTED_D}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k must be (B, S, Hk, D) = ({B}, {S}, Hk, {D}), "
                         f"got {tuple(k.shape)}")
    Hk = k.shape[2]
    if Hk < 1 or Hq % Hk:
        raise ValueError(f"Hq={Hq} must be a multiple of Hk={Hk}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must be {tuple(k.shape)}, got {tuple(v.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share one dtype")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def tile_plan(B: int, S: int, Hq: int, Hk: int, D: int, causal: bool = True,
              window: Optional[int] = None) -> dict:
    """How the bf16 kernel cuts the work into blocks of ROWS_PER_BLOCK query
    rows: ``heads_per_block`` heads of one group (all g of them, up to 64)
    times ``tokens_per_block`` token positions; ``head_chunks`` blocks cover
    a group's heads, ``token_tiles`` cover S.  ``kv_l2_bytes``: the K and V
    bytes a call fetches from L2, every block loading each kv tile (of
    ``tc_block_n`` keys: 128 at D <= 64, else 64) that the causal mask and
    the window let its tokens see, its rows inside S once."""
    g = Hq // Hk
    hb = min(g, ROWS_PER_BLOCK)
    T = ROWS_PER_BLOCK // hb
    chunks, tiles = -(-g // hb), -(-S // T)
    BN = 128 if D <= 64 else 64
    kv_rows = 0
    for t in range(tiles):
        lo, hi = t * T, min(t * T + T, S) - 1
        end = hi // BN + 1 if causal else -(-S // BN)
        begin = (lo - window + 1) // BN if window and lo - window + 1 > 0 else 0
        kv_rows += sum(min(BN, S - kt * BN) for kt in range(begin, end))
    return dict(heads_per_block=hb, tokens_per_block=T, head_chunks=chunks,
                token_tiles=tiles, blocks=B * Hk * chunks * tiles,
                kv_l2_bytes=B * Hk * chunks * kv_rows * 2 * D * 2)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    lib.flash_attention_occupancy.argtypes = [ctypes.c_int]
    lib.flash_attention_occupancy.restype = ctypes.c_int
    return lib


def smem_bytes(D: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Dynamic shared memory one block of the kernel for ``dtype`` takes at
    head size ``D`` (builds the kernel if needed)."""
    n = _lib().flash_attention_smem_bytes(D, int(dtype == torch.bfloat16))
    if n < 0:
        raise ValueError(f"no kernel built for D={D}")
    return n


def occupancy(D: int) -> int:
    """Blocks of the bf16 kernel at head size ``D`` that one SM of the
    current CUDA device holds, by CUDA's occupancy calculator (builds the
    kernel if needed)."""
    n = _lib().flash_attention_occupancy(D)
    if n < 0:
        raise RuntimeError(f"no occupancy for the bf16 attention kernel at D={D}")
    return n


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Launch the attention kernel.  q ``(B,S,Hq,D)``, k and v ``(B,S,Hk,D)``,
    all float32 or all bfloat16, contiguous, on one CUDA device; D in
    {32, 64, 128, 256}, any ``S >= 1``.  Returns ``(B,S,Hq,D)`` in q's dtype.

    bfloat16 launches the tensor-core kernel, float32 the SIMT kernel.
    ``flash_attention.launches`` counts launches, ``wgmma_launches`` and
    ``simt_launches`` each route's."""
    check_attention_args(q, k, v, window)
    bf16 = q.dtype == torch.bfloat16
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention launches a CUDA kernel; got tensors on {q.device} "
            "(CPU tensors go through repro_torch.kernels.ops.attention)"
        )
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    if bf16:   # TMA reads 16-byte aligned tensors; a view at an odd offset is copied
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    o = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            B, S, Hq, Hk, D, 1.0 / math.sqrt(D), int(causal),
            window or 0, int(bf16), stream,
        )
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} (cudaError {err})")
    flash_attention.launches += 1
    if bf16:
        flash_attention.wgmma_launches += 1
    else:
        flash_attention.simt_launches += 1
    return o


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.simt_launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        from .ops import attention

        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, grad):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (q, k, v)]
            out = attention_ref(*leaves, causal=ctx.causal, window=ctx.window)
            dq, dk, dv = torch.autograd.grad(out, leaves, grad)
        return dq, dk, dv, None, None


def flash_attention_trainable(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: Optional[int] = None,
) -> torch.Tensor:
    """Attention forward through ``ops.attention`` with the oracle backward
    (recompute through ``attention_ref`` and differentiate it)."""
    return _FlashAttention.apply(q, k, v, causal, window)
