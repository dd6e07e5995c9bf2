"""The kernels' route on the meta device: shapes and counted work, no
computation.

The dry-run (``launch/dryrun.py``) traces a whole step on the meta device,
where tensors have shapes and dtypes but no storage.  Its operation counts
come from ``FlopCounterMode`` over the aten ops; a hand-written kernel is
not an aten op, so its wrapper, given meta tensors, returns meta outputs of
the right shapes and dtypes and adds the kernel's own work, counted from
its shapes by the formulas below, to every :class:`KernelWork` opened by
:func:`count_kernel_work`.  Nothing is computed on meta and no plain
version runs there.  Operations follow ``FlopCounterMode``'s convention for
products (a multiply and an add are two):

  * attention: 4*D operations (q.k and p.v) for each (query, key) pair the
    causal mask and the window let in, counted exactly (the same reckoning
    as ``chip_smoke.py``'s bound: 34,376,515,584 at B=4, S=2048, H=16,
    D=64); bytes: q, k, v read and o written once.
  * decode: with ``lengths = C`` (a meta tensor's values cannot be read), 4*D
    operations for each (query head, cache slot) pair; bytes: q read, o
    written, K and V read once up to each length, the lengths.
  * WKV: the kernel's three passes (:func:`wkv_cost`, which
    ``chip_smoke.py``'s bound reads too), at the chunk and sub-chunk that
    ``csrc/rwkv6_scan.cu`` declares: the state increments and the carry,
    the factored A and the products; bytes: r, k, v, y in the activation
    dtype, w, u, S0 and S_T in float32, once.
  * WKV backward (the port's backward recomputes the sequential
    recurrence and differentiates it; its Python loop of T steps is too
    slow to trace on meta at 4096 tokens): the ``bmm`` operations that
    ``FlopCounterMode`` counts in that backward, 6*N^2 a (b, h, t); bytes:
    the inputs and the state read and written at each step, forward and
    backward, and the gradients written once.
"""
from __future__ import annotations

import contextlib
import functools
import re
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .build import CSRC

__all__ = ["KernelWork", "count_kernel_work", "attention_work", "decode_work", "wkv_tiling",
           "wkv_cost", "wkv_work", "wkv_backward_work", "attention", "decode_attention",
           "rwkv6", "rwkv6_backward"]


@dataclass
class KernelWork:
    """Operations and bytes of the kernel calls made on meta, by kernel."""
    flops: int = 0
    bytes: int = 0
    calls: Dict[str, int] = field(default_factory=dict)

    def add(self, name: str, flops: int, nbytes: int) -> None:
        self.flops += flops
        self.bytes += nbytes
        self.calls[name] = self.calls.get(name, 0) + 1


_open: List[KernelWork] = []


@contextlib.contextmanager
def count_kernel_work() -> Iterator[KernelWork]:
    """A :class:`KernelWork` that counts every meta kernel call made inside
    the ``with``."""
    work = KernelWork()
    _open.append(work)
    try:
        yield work
    finally:
        _open.remove(work)


def _count(name: str, flops: int, nbytes: int) -> None:
    for work in _open:
        work.add(name, int(flops), int(nbytes))


def _pairs(S: int, causal: bool, window: Optional[int]) -> int:
    i = np.arange(S, dtype=np.int64)
    hi = i + 1 if causal else np.full(S, S, dtype=np.int64)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, dtype=np.int64)
    return int((hi - lo).sum())


def attention_work(B: int, S: int, Hq: int, Hk: int, D: int, elem_bytes: int,
                   causal: bool = True, window: Optional[int] = None) -> Tuple[int, int]:
    """(operations, bytes) of one attention call."""
    nbytes = (2 * B * S * Hq * D + 2 * B * S * Hk * D) * elem_bytes
    return 4 * D * _pairs(S, causal, window) * B * Hq, nbytes


def decode_work(B: int, Hq: int, Hk: int, D: int, slots: int, elem_bytes: int,
                kv_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of one decode call over ``slots`` valid cache
    slots in all (the sum of the rows' lengths)."""
    return (4 * D * Hq * slots,
            2 * B * Hq * D * elem_bytes + 2 * slots * Hk * D * kv_bytes + 4 * B)


@functools.lru_cache(maxsize=None)
def wkv_tiling() -> Tuple[int, int]:
    """(chunk, sub-chunk) in tokens, as ``csrc/rwkv6_scan.cu`` declares
    them (``kChunk``, ``kSub``); read from the source, so the count follows
    the kernel with no build."""
    src = (CSRC / "rwkv6_scan.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kChunk", "kSub"))


@functools.lru_cache(maxsize=None)
def _wkv_ops(T: int, N: int, chunk: int, sub: int) -> Tuple[int, int]:
    simt = prod = 0
    for t0 in range(0, T, chunk):
        L = min(chunk, T - t0)
        subs = [min(sub, L - s0) for s0 in range(0, L, sub)]
        simt += 2 * L * N * N + 2 * N * N + 3 * L * N
        simt += sum(5 * (l * (l - 1) // 2) * N + 3 * l * N for l in subs)
        prod += 2 * L * N * N + 2 * (L * (L - 1) // 2 + L) * N
        prod += sum(2 * subs[q] * subs[p] * N for q in range(len(subs)) for p in range(q))
    return simt, prod


def wkv_cost(B: int, T: int, H: int, N: int, elem_bytes: int,
             chunk: Optional[int] = None) -> Tuple[int, int, int]:
    """(bytes, SIMT operations, product operations) the WKV scan needs for
    these shapes, counted as the kernel splits the work: chunks of ``chunk``
    tokens (default: the source's), A factored over sub-chunks.

    Bytes: r, k, v and y in the activation dtype and w in f32, each read or
    written once; u, S0 and S_T in f32 (the kernel's per-chunk scratch not
    counted).  Per (b, h) and chunk of L valid tokens, SIMT operations
    (f32 in both instantiations): the state increment (k e^{total-cum})^T v
    and the carry S <- e^{total} S + dS; A's diagonal sub-chunk blocks
    (subtract, exp, two multiplies, add a term below the diagonal; the u
    term on it); the log, cumulative sum and decay factors.  Product
    operations (TF32 tensor cores in bf16, SIMT in f32): (r e^{cum_exc}) @ S,
    A's blocks below the diagonal sub-chunks as products of factors, and
    A @ v over i <= t.  A ragged last chunk counts its valid tokens only.
    """
    src_chunk, sub = wkv_tiling()
    simt, prod = _wkv_ops(T, N, chunk or src_chunk, sub)
    nbytes = B * T * H * N * (4 * elem_bytes + 4) + H * N * 4 + 2 * B * H * N * N * 4
    return nbytes, B * H * simt, B * H * prod


def wkv_work(B: int, T: int, H: int, N: int, elem_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of one call of the WKV kernel's three passes."""
    nbytes, simt, prod = wkv_cost(B, T, H, N, elem_bytes)
    return simt + prod, nbytes


def wkv_backward_work(B: int, T: int, H: int, N: int, elem_bytes: int) -> Tuple[int, int]:
    """(operations, bytes) of the WKV backward: the recurrence recomputed
    and differentiated step by step."""
    per_step = B * H * N * N * 4              # the f32 state
    inputs = B * T * H * N * (4 * elem_bytes + 4) + H * N * 4 + B * H * N * N * 4
    return 6 * B * H * T * N * N, 2 * inputs + 4 * T * per_step


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int]) -> torch.Tensor:
    B, S, Hq, D = q.shape
    _count("flash_attention", *attention_work(B, S, Hq, k.shape[2], D, q.element_size(),
                                              causal, window))
    return torch.empty_like(q)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    B, Hq, D = q.shape
    _count("flash_decode", *decode_work(B, Hq, k.shape[2], D, B * k.shape[1],
                                        q.element_size(), k.element_size()))
    return torch.empty((B, Hq, D), dtype=q.dtype, device=q.device)


def rwkv6(r, k, v, w, u, S0) -> Tuple[torch.Tensor, torch.Tensor]:
    B, T, H, N = r.shape
    _count("rwkv6_scan", *wkv_work(B, T, H, N, r.element_size()))
    return torch.empty_like(r), torch.empty((B, H, N, N), dtype=torch.float32, device=r.device)


def rwkv6_backward(r, k, v, w, u, S0) -> Tuple[torch.Tensor, ...]:
    """The gradients of the WKV backward's inputs, empty, its work counted."""
    B, T, H, N = r.shape
    _count("rwkv6_scan backward", *wkv_backward_work(B, T, H, N, r.element_size()))
    return tuple(torch.empty_like(t) for t in (r, k, v, w, u, S0))
