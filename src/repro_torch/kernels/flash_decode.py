"""Python wrapper for flash decode, a CUDA kernel for Hopper.

The kernel (``csrc/flash_decode.cu``) replaces the JAX package's Pallas TPU
kernel ``repro.kernels.flash_decode.flash_decode``: attention of one query
token over a padded KV cache, the g = Hq/Hk query heads of a group sharing
each K/V tile.  Its source comment says what bounds it on the H100 and how
its design answers that.  :func:`flash_decode` checks its arguments,
allocates the output, launches one kernel on PyTorch's current stream and
raises if the launch fails.  The split scratch (partials and the merge
counters) is allocated once per (device, stream) and grown when a larger
shape needs more, so an eager call allocates nothing else; a call captured in
a CUDA graph takes a scratch of the graph's own, so a replay shares no
counters with eager calls on another stream.  K and V may be in q's
dtype, in float8 (``float8_e4m3fn``, ``float8_e5m2``: a float8 KV cache,
read as it is stored and widened in the kernel), or in another float dtype:
bf16 or f16 under an f32 q, f32 or f16 under a bf16 q (a cache in another
``kv_dtype`` than the model's, converted into q's dtype in the kernel, a
narrowing rounded to nearest even).  ``flash_decode.kind_launches`` counts
the launches on K/V in another dtype than q's, by (q dtype, K/V dtype).
It takes CUDA tensors only: CPU tensors go to the plain version through
:func:`repro_torch.kernels.ops.decode_attention`.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from .build import load

__all__ = ["flash_decode", "check_decode_args", "kv_kind", "split_plan", "smem_bytes",
           "blocks_per_sm"]

_SUPPORTED_D = (32, 64, 128, 256)
# the kernel's kv_kind for K/V in q's dtype (0) and, by (q dtype, K/V
# dtype), for every other pair it is built for
_KV_KIND = {
    (torch.float32, torch.float8_e4m3fn): 1, (torch.bfloat16, torch.float8_e4m3fn): 1,
    (torch.float32, torch.float8_e5m2): 2, (torch.bfloat16, torch.float8_e5m2): 2,
    (torch.float32, torch.bfloat16): 3,
    (torch.float32, torch.float16): 4, (torch.bfloat16, torch.float16): 4,
    (torch.bfloat16, torch.float32): 5,
}
_TILE = 64              # cache slots per tile of the kernel
_BLOCKS_PER_SM = 2      # a full cache gives about this many blocks per SM, all resident
# At D=256 one block fills an SM, and a split of one or two tiles spends
# more on its fixed costs and the merge than its ring overlaps: splits of
# four tiles were among the fastest at RecurrentGemma's decode shapes on an
# H100 (21.6-28.5 us against 25.4-65.0 us for one tile; PERF.md, §6).
_MIN_TILES = {256: 4}


def kv_kind(q_dtype: torch.dtype, kv_dtype: torch.dtype) -> Optional[int]:
    """The kernel's kv_kind for K/V in ``kv_dtype`` under q in ``q_dtype``,
    or None where no kernel is built for the pair."""
    if q_dtype not in (torch.float32, torch.bfloat16):
        return None
    return 0 if kv_dtype == q_dtype else _KV_KIND.get((q_dtype, kv_dtype))


def check_decode_args(q, k, v, lengths) -> None:
    """Raise on any argument the kernel does not take: shapes, dtypes,
    contiguity, alignment and devices."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D), got {tuple(q.shape)}")
    B, Hq, D = q.shape
    if D not in _SUPPORTED_D:
        raise ValueError(f"head size D={D} not in {_SUPPORTED_D}")
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or k.shape[1] < 1:
        raise ValueError(f"k must be (B, C, Hk, D) = ({B}, C, Hk, {D}), got {tuple(k.shape)}")
    Hk = k.shape[2]
    if Hk < 1 or Hq % Hk:
        raise ValueError(f"Hq={Hq} must be a multiple of Hk={Hk}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v must be {tuple(k.shape)}, got {tuple(v.shape)}")
    if B < 1:
        raise ValueError(f"B={B} must be >= 1")
    if tuple(lengths.shape) != (B,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({B},) int32, got {tuple(lengths.shape)} "
                         f"{lengths.dtype}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != v.dtype:
        raise TypeError(f"k and v must share one dtype; got {k.dtype} and {v.dtype}")
    if kv_kind(q.dtype, k.dtype) is None:
        raise TypeError(f"no kernel for K/V in {k.dtype} under q in {q.dtype}: K/V in q's "
                        "dtype, a float8 one, bfloat16 or float16 under float32 q, or float32 "
                        "or float16 under bfloat16 q")
    for name, a in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if a.device != q.device:
            raise ValueError(f"{name} is on {a.device}, q on {q.device}")
    for name, a in (("q", q), ("k", k), ("v", v)):
        if a.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")


def split_plan(B: int, Hk: int, C: int, n_sm: int, D: int = 128,
               per_sm: int = _BLOCKS_PER_SM) -> Tuple[int, int]:
    """``(split_keys, nsplit)``: the cache axis cut into ``nsplit`` splits of
    ``split_keys`` slots, a multiple of the kernel's 64-slot tile and at
    least ``_MIN_TILES`` tiles at head size ``D``, so that the ``B * Hk * nsplit`` blocks come
    to about ``per_sm`` per SM when the cache is full: two fit on an SM
    at once in bf16 at D=128, so a full cache is one wave, and each split
    holds several tiles for its load ring to overlap (four at the serving
    shape).  The same plan serves float8 K/V: their ring and widened tile
    take no more shared memory than q's dtype's ring (:func:`smem_bytes`), so
    as many blocks fit on an SM.  K/V kinds whose ring and converted tile
    take more than q's dtype's ring (f16 or f32 K/V under bf16 q) are
    planned at one block an SM (:func:`blocks_per_sm`): half the splits,
    twice the tiles a split."""
    tiles = -(-C // _TILE)
    want = max(1, min(tiles, -(-per_sm * n_sm // (B * Hk))))
    split_keys = _TILE * max(-(-tiles // want), min(_MIN_TILES.get(D, 1), tiles))
    return split_keys, -(-C // split_keys)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("flash_decode")
    fn = lib.flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.flash_decode_error_string.argtypes = [ctypes.c_int]
    lib.flash_decode_error_string.restype = ctypes.c_char_p
    lib.flash_decode_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.flash_decode_smem_bytes.restype = ctypes.c_int
    lib.flash_decode_heads_per_block.argtypes = [ctypes.c_int]
    lib.flash_decode_heads_per_block.restype = ctypes.c_int
    return lib


def smem_bytes(D: int, dtype: torch.dtype = torch.bfloat16,
               kv_dtype: Optional[torch.dtype] = None) -> int:
    """Dynamic shared memory one block of the kernel takes at head size
    ``D`` for q in ``dtype`` and K/V in ``kv_dtype`` (q's if None; builds
    the kernel if needed)."""
    kind = kv_kind(dtype, dtype if kv_dtype is None else kv_dtype)
    if kind is None:
        raise TypeError(f"no kernel for K/V in {kv_dtype} under q in {dtype}")
    return _lib().flash_decode_smem_bytes(D, int(dtype == torch.bfloat16), kind)


@functools.cache
def blocks_per_sm(D: int, dtype: torch.dtype, kv_dtype: torch.dtype) -> int:
    """Blocks an SM the split plan aims at for q in ``dtype`` and K/V in
    ``kv_dtype``: ``_BLOCKS_PER_SM``, or one where the K/V kind's shared
    memory exceeds that of q's dtype's ring (builds the kernel if needed)."""
    return _BLOCKS_PER_SM if smem_bytes(D, dtype, kv_dtype) <= smem_bytes(D, dtype) else 1


class _Scratch:
    """The kernel's split scratch for one stream: f32 partials and their
    (m, l), and the int32 merge counters, which start at zero and which
    every call leaves at zero.  Grown when a call needs more."""

    def __init__(self, device: torch.device):
        self.device = device
        self.acc = torch.empty(0, dtype=torch.float32, device=device)
        self.ml = torch.empty(0, dtype=torch.float32, device=device)
        self.counters = torch.zeros(0, dtype=torch.int32, device=device)

    def get(self, n_acc: int, n_ml: int, n_rows: int):
        if n_acc > self.acc.numel() or n_ml > self.ml.numel():
            self.acc = torch.empty(max(n_acc, self.acc.numel()), dtype=torch.float32,
                                   device=self.device)
            self.ml = torch.empty(max(n_ml, self.ml.numel()), dtype=torch.float32,
                                  device=self.device)
        if n_rows > self.counters.numel():
            self.counters = torch.zeros(n_rows, dtype=torch.int32, device=self.device)
        return self.acc, self.ml, self.counters


# eager calls' scratch, by (device, stream): calls on one stream are ordered,
# so they may share one; calls on two streams may overlap, so they may not
_SCRATCH: Dict[Tuple[torch.device, int], _Scratch] = {}


def _scratch(device: torch.device) -> _Scratch:
    """The scratch for a call on ``device``'s current stream.  Under CUDA
    graph capture a new one, in the graph's memory pool, whose counters a
    node of the graph zeroes before the kernel on every replay: a replay may
    run beside eager calls, or beside another graph captured on the same
    stream, and shares no scratch with either."""
    if torch.cuda.is_current_stream_capturing():
        return _Scratch(device)
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        scratch = _SCRATCH[key] = _Scratch(device)
    return scratch


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Launch the decode kernel.  q ``(B,Hq,D)`` float32 or bfloat16, k and v
    ``(B,C,Hk,D)`` in q's dtype or both in one float8 dtype, contiguous, on
    one CUDA device; ``lengths``
    ``(B,)`` int32 on the same device, each in ``[1, C]`` (only slots
    ``j < lengths[b]`` count; the kernel reads no slot beyond).  K and V may
    also be in another float dtype than q's (:func:`kv_kind`).  D in
    {32, 64, 128, 256}, any C, any B and Hk.  Returns ``(B,Hq,D)`` in q's dtype.
    One kernel launch a call; eager calls on one stream share the split
    scratch, and a captured call has its own.  ``flash_decode.launches``
    counts launches, ``flash_decode.kind_launches[(q dtype, K/V dtype)]``
    those on each K/V dtype other than q's."""
    check_decode_args(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_decode launches a CUDA kernel; got tensors on {q.device} "
            "(CPU tensors go through repro_torch.kernels.ops.decode_attention)"
        )
    B, Hq, D = q.shape
    C, Hk = k.shape[1], k.shape[2]
    split_keys, nsplit = split_plan(B, Hk, C, _sm_count(q.device.index or 0), D,
                                    blocks_per_sm(D, q.dtype, k.dtype))
    is_bf16 = int(q.dtype == torch.bfloat16)
    lib = _lib()
    kh = lib.flash_decode_heads_per_block(is_bf16)
    rows = B * Hk * -(-(Hq // Hk) // kh)
    part_acc, part_ml, counters = _scratch(q.device).get(
        rows * nsplit * kh * D, rows * nsplit * kh * 2, rows)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), counters.data_ptr(), B, C, Hq, Hk, D,
            split_keys, nsplit, 1.0 / math.sqrt(D), is_bf16, kv_kind(q.dtype, k.dtype), stream,
        )
    if err != 0:
        msg = lib.flash_decode_error_string(err).decode()
        raise RuntimeError(f"flash_decode launch failed: {msg} (cudaError {err})")
    flash_decode.launches += 1
    if k.dtype != q.dtype:
        key = (q.dtype, k.dtype)
        flash_decode.kind_launches[key] = flash_decode.kind_launches.get(key, 0) + 1
    return o


flash_decode.launches = 0
flash_decode.kind_launches = {}
