"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA card with CUDA and skip without one.  They import
neither JAX nor the JAX package, so they run where only the port does:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import rwkv6_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan

# the tolerances of the JAX package's own kernel sweep (tests/test_kernels.py)
TOL = {torch.float32: dict(atol=2e-3, rtol=2e-3), torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _wkv_inputs(seed, B, T, H, N, dtype, device):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    return dict(
        r=t(rng.standard_normal((B, T, H, N)) * 0.5).to(dtype),
        k=t(rng.standard_normal((B, T, H, N)) * 0.5).to(dtype),
        v=t(rng.standard_normal((B, T, H, N))).to(dtype),
        w=t(rng.uniform(0.2, 0.999, (B, T, H, N))),
        u=t(rng.standard_normal((H, N)) * 0.2),
        S0=t(rng.standard_normal((B, H, N, N)) * 0.1),
    )


def _np(t):
    return t.detach().to(torch.float32).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,N", [(1, 64, 4, 64), (2, 80, 3, 32), (1, 200, 2, 64),
                                     (1, 7, 2, 64), (2, 128, 2, 32), (1, 1, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_matches_plain_version(cuda_device, B, T, H, N, dtype):
    inp = _wkv_inputs(5, B, T, H, N, dtype, cuda_device)
    before = rwkv6_scan.launches
    y, s = ops.rwkv6(**inp)
    torch.cuda.synchronize()
    assert rwkv6_scan.launches == before + 1
    yr, sr = rwkv6_ref(**inp)
    assert y.dtype == dtype and s.dtype == torch.float32
    np.testing.assert_allclose(_np(y), _np(yr), **TOL[dtype])
    np.testing.assert_allclose(_np(s), _np(sr), **TOL[dtype])


@pytest.mark.cuda
def test_rwkv6_kernel_state_carry_composes(cuda_device):
    """Two kernel calls with the state carried == one call, ragged split."""
    inp = _wkv_inputs(6, 1, 160, 4, 64, torch.float32, cuda_device)
    y_full, s_full = rwkv6_scan(**inp)
    seq = ("r", "k", "v", "w")
    y1, s1 = rwkv6_scan(**{key: (val[:, :70].contiguous() if key in seq else val)
                           for key, val in inp.items()})
    rest = {key: (val[:, 70:].contiguous() if key in seq else val) for key, val in inp.items()}
    rest["S0"] = s1
    y2, s2 = rwkv6_scan(**rest)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y_full), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(_np(s2), _np(s_full), atol=2e-3, rtol=2e-3)
