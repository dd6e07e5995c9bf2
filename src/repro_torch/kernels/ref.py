"""Plain PyTorch versions of the port's kernels.

Each function is the mathematical ground truth its kernel is held against,
on the CPU in the tests and on the card in ``chip_smoke.py``.  A wrapper
takes the plain version only for tensors that lie on the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rwkv6_ref"]


def rwkv6_ref(
    r: torch.Tensor,            # (B, T, H, N)
    k: torch.Tensor,            # (B, T, H, N)
    v: torch.Tensor,            # (B, T, H, N)
    w: torch.Tensor,            # (B, T, H, N) per-channel decay in (0, 1)
    u: torch.Tensor,            # (H, N) bonus
    S0: torch.Tensor,           # (B, H, N, N) initial state [k-dim, v-dim]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential RWKV6 WKV recurrence, for any ``T``:

        y_t = r_t . (S_{t-1} + u * k_t (x) v_t)
        S_t = diag(w_t) S_{t-1} + k_t (x) v_t

    Returns ``(y (B,T,H,N) in r's dtype, S_T (B,H,N,N) float32)``.
    """
    f32 = torch.float32
    rs, ks, vs, ws = (a.to(f32) for a in (r, k, v, w))
    uf = u.to(f32)[..., :, None]
    S = S0.to(f32)
    ys = []
    for t in range(r.shape[1]):
        kv = ks[:, t, :, :, None] * vs[:, t, :, None, :]          # (B,H,N,N)
        ys.append(torch.einsum("bhi,bhij->bhj", rs[:, t], S + uf * kv))
        S = ws[:, t, :, :, None] * S + kv
    y = torch.stack(ys, dim=1) if ys else rs.new_zeros(rs.shape)
    return y.to(r.dtype), S
