"""Casts between the float dtypes a KV cache and the model may use, as JAX
computes them.

The model writes its KV cache through :func:`astype` and the plain decode
attention reads K/V back in q's dtype through it, so the port rounds and
widens a cache exactly as the JAX model's ``x.astype(dtype)`` does, in every
``kv_dtype`` the JAX ``ModelConfig`` may name.
"""
from __future__ import annotations

import torch

__all__ = ["FLOAT8", "astype"]

# the float8 dtypes a KV cache may be stored in (``kv_dtype``)
FLOAT8 = (torch.float8_e4m3fn, torch.float8_e5m2)
# float8_e4m3fn's largest finite value is 448; values of magnitude above 464,
# halfway to the next step (480, the NaN encoding), overflow
_E4M3_OVERFLOW = 464.0
# bfloat16's quiet NaN, 0x7fc0, and with the sign bit, 0xffc0, as int16
_BF16_QNAN, _BF16_NEG_QNAN = 0x7FC0, 0xFFC0 - 0x10000


def astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it, bit for bit, for every
    value of float32, bfloat16 and float16, into any of those dtypes or a
    float8 one.  Torch's cast agrees (rounding to nearest even, overflow to
    infinity, subnormals kept or flushed alike) but for NaNs and one float8
    case, fixed up on an integer view:

    * into bfloat16 from float32 or float16, a NaN: JAX gives 0x7fc0 with
      x's sign bit; torch gives 0xffff (float32 on the CPU) or 0x7fc0 whatever
      the sign (float16).
    * float8_e4m3fn has no infinity.  Where |x| > 464 (infinities
      included) JAX gives NaN (0x7f, with x's sign bit); torch saturates to
      +-448 (0x7e, with the sign bit), one code below it.
    * float8_e5m2 from a NaN: JAX gives 0x7f from bfloat16 whatever the
      sign, and 0x7e with the sign bit from float32; torch keeps the sign
      and gives 0x7f.

    Every other value rounds to the nearest even in both."""
    y = x.to(dtype)
    if not x.is_floating_point() or x.dtype in FLOAT8 or x.dtype == dtype:
        return y
    if dtype == torch.bfloat16:
        nan = torch.where(torch.signbit(x), _BF16_NEG_QNAN, _BF16_QNAN).to(torch.int16)
        return torch.where(torch.isnan(x), nan,
                           y.view(torch.int16)).view(torch.bfloat16)
    if dtype not in FLOAT8:
        return y
    bits = y.view(torch.uint8)
    if dtype == torch.float8_e4m3fn:
        bits = bits + (x.abs() > _E4M3_OVERFLOW)
    elif x.dtype == torch.bfloat16:
        bits = torch.where(torch.isnan(x), 0x7F, bits)
    else:
        bits = bits - torch.isnan(x).to(torch.uint8)
    return bits.view(dtype)
