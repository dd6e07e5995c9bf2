"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need an NVIDIA card with CUDA and skip without one.  They import
neither JAX nor the JAX package, so they run where only the port does:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import batched
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_trainable
from repro_torch.kernels.flash_decode import check_decode_args, flash_decode
from repro_torch.kernels.ref import attention_ref, decode_attention_ref, rwkv6_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan, rwkv6_scan_trainable
from repro_torch.models.layers import astype

# the tolerances of the JAX package's own kernel sweep (tests/test_kernels.py)
TOL = {torch.float32: dict(atol=2e-3, rtol=2e-3), torch.bfloat16: dict(atol=5e-2, rtol=5e-2)}
# attention: the sweep's 3e-5 in f32 becomes 1e-4, as the card sums in
# another order than the plain version's matmuls; bf16 keeps the sweep's 3e-2
ATTN_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=3e-2, rtol=3e-2)}
# the bf16 WKV kernel against the plain version on its inputs cast up to
# float32: beyond half a bf16 ulp of y (at most 2^-8 of |y|), at most this
# share of max |y|, room for its TF32 products (as chip_smoke.py holds it:
# at most 2.4e-4 of max |y| measured on an H100, so about 2x that)
BF16_HALF_ULP = 2.0 ** -8
WKV_BF16_UPCAST_TOL = 5e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


def _wkv_inputs(seed, B, T, H, N, dtype, device, strong_decay=False):
    """WKV inputs; with ``strong_decay`` half the channels decay as
    w = exp(-exp(x + 2)), so a 16-token sub-chunk's cumulative log-decay
    falls below -87 and its exponential underflows in f32."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    w = rng.uniform(0.2, 0.999, (B, T, H, N))
    if strong_decay:
        w[..., : N // 2] = np.exp(-np.exp(rng.standard_normal((B, T, H, N // 2)) + 2.0))
    return dict(
        r=t(rng.standard_normal((B, T, H, N)) * 0.5).to(dtype),
        k=t(rng.standard_normal((B, T, H, N)) * 0.5).to(dtype),
        v=t(rng.standard_normal((B, T, H, N))).to(dtype),
        w=t(w),
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
@pytest.mark.parametrize("T", [1, 15, 16, 17, 200, 512])
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_at_served_lengths(cuda_device, B, T, dtype):
    """Lengths around the 16-token sub-chunk and the 64-token chunk, a served
    prompt (200) and the longest (512), at batch 1 and 8."""
    inp = _wkv_inputs(15, B, T, 3, 64, dtype, cuda_device)
    y, s = rwkv6_scan(**inp)
    torch.cuda.synchronize()
    yr, sr = rwkv6_ref(**inp)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL[dtype])
    np.testing.assert_allclose(_np(s), _np(sr), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("T", [64, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_kernel_under_strong_decay(cuda_device, T, dtype):
    """The factored A stays finite and right where e^{cum} underflows."""
    inp = _wkv_inputs(16, 2, T, 4, 64, dtype, cuda_device, strong_decay=True)
    assert float(torch.log(inp["w"][:, :16, :, :32]).sum(1).min()) < -87   # one sub-chunk
    y, s = rwkv6_scan(**inp)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    yr, sr = rwkv6_ref(**inp)
    np.testing.assert_allclose(_np(y), _np(yr), **TOL[dtype])
    np.testing.assert_allclose(_np(s), _np(sr), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("T,strong_decay", [(64, False), (200, False), (512, False),
                                            (200, True)])
def test_rwkv6_bf16_kernel_against_the_float32_plain_version(cuda_device, T, strong_decay):
    """The bf16 kernel (its products on the tensor cores in TF32) against the
    plain version on its inputs cast up to float32: beyond the rounding of
    its bf16 y (at most 2^-8 of |y|), within WKV_BF16_UPCAST_TOL of max |y|;
    S_T, whose update stays in f32, within the f32 tolerance."""
    inp = _wkv_inputs(17, 2, T, 4, 64, torch.bfloat16, cuda_device, strong_decay=strong_decay)
    y, s = rwkv6_scan(**inp)
    torch.cuda.synchronize()
    yu, su = rwkv6_ref(**{**inp, **{key: inp[key].float() for key in ("r", "k", "v")}})
    beyond = float(((y.float() - yu).abs() - BF16_HALF_ULP * yu.abs()).max())
    assert beyond <= WKV_BF16_UPCAST_TOL * float(yu.abs().max())
    np.testing.assert_allclose(_np(s), _np(su), **TOL[torch.float32])


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


def _attn_inputs(seed, B, S, Hq, Hk, D, dtype, device):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device).to(dtype)

    return t(B, S, Hq, D), t(B, S, Hk, D), t(B, S, Hk, D)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hq,Hk,D,causal,window", [
    (2, 256, 8, 2, 64, True, None),
    (1, 256, 4, 4, 128, True, None),
    (2, 512, 8, 1, 64, True, None),
    (1, 128, 2, 2, 32, True, None),
    (1, 200, 4, 2, 32, True, 128),     # ragged S, window
    (1, 512, 4, 2, 64, True, 64),
    (2, 130, 2, 2, 64, False, None),   # ragged, non-causal
    (1, 300, 4, 1, 128, False, 100),   # non-causal window
    (1, 2, 2, 1, 64, True, None),
    (1, 1, 2, 2, 32, True, None),
    # one 64x64 tile, then S past a tile edge, a ragged last tile, and the
    # training length; D=128 with g=4 (16 tokens x 4 heads a block) and D=64
    # MHA (64 tokens a block)
    (1, 64, 8, 2, 128, True, None),
    (1, 65, 8, 2, 128, True, None),
    (1, 127, 8, 2, 128, True, None),
    (1, 2048, 8, 2, 128, True, None),
    (1, 64, 2, 2, 64, True, None),
    (1, 65, 2, 2, 64, True, None),
    (1, 127, 2, 2, 64, True, None),
    (1, 2048, 2, 2, 64, True, None),
    (1, 300, 8, 2, 128, True, 100),    # window starting mid-tile, GQA
    (2, 333, 2, 2, 64, True, 77),      # window starting mid-tile, MHA
    (2, 100, 6, 2, 64, True, None),    # g=3: 21 tokens x 3 heads, 1 row idle
    (1, 9, 160, 1, 32, True, None),    # g=160: three head chunks, the last partial
    (1, 190, 16, 2, 32, False, None),  # non-causal GQA, D=32
    # the MoE serving path's heads (qwen2-moe-a2.7b, g=1: one head x 64 tokens
    # a block) at its longest prefill and a ragged one, and command-r-plus's
    # g=12 (12 heads x 5 tokens, 60 of 64 rows)
    (1, 512, 16, 16, 128, True, None),
    (1, 97, 16, 16, 128, True, None),
    (1, 300, 96, 8, 128, True, None),
    (1, 65, 96, 8, 128, True, None),
    # RecurrentGemma's heads (MQA, g=16: 4 tokens x 16 heads a block, D=256)
    # at its served prefill with its 2048-token window, a window that masks
    # (starting mid-tile, S ragged), a non-causal case and two kv heads
    (1, 512, 16, 1, 256, True, 2048),
    (1, 1100, 16, 1, 256, True, 300),
    (1, 70, 16, 1, 256, False, None),
    (2, 129, 32, 2, 256, True, 64),
    # Whisper's decoder (MHA, g=1, D=64) at its training shape (S=448, a
    # ragged last tile), and Qwen2-VL's heads (g=8, D=128) at its training
    # length
    (8, 448, 6, 6, 64, True, None),
    (1, 2048, 64, 8, 128, True, None),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_version(cuda_device, B, S, Hq, Hk, D, causal,
                                                window, dtype):
    q, k, v = _attn_inputs(7, B, S, Hq, Hk, D, dtype, cuda_device)
    before = flash_attention.launches
    out = ops.attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[dtype])


@pytest.mark.cuda
def test_f32_attention_kernel_takes_more_than_65535_heads(cuda_device):
    """B * Hq = 65,568 rows of (b, head), past the 65535 of one grid axis."""
    q, k, v = _attn_inputs(17, 2049, 4, 32, 32, 32, torch.float32, cuda_device)
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref = attention_ref(q, k, v, causal=True)
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[torch.float32])


@pytest.mark.cuda
def test_attention_routes_bf16_to_the_tensor_core_kernel(cuda_device):
    """bf16 launches the wgmma kernel, float32 the SIMT kernel; each route
    has its own count beside the total."""
    for dtype, route in ((torch.bfloat16, "wgmma_launches"), (torch.float32, "simt_launches")):
        q, k, v = _attn_inputs(14, 1, 96, 4, 2, 64, dtype, cuda_device)
        counts = {name: getattr(flash_attention, name)
                  for name in ("launches", "wgmma_launches", "simt_launches")}
        ops.attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        for name, before in counts.items():
            assert getattr(flash_attention, name) == before + (name in ("launches", route))


@pytest.mark.cuda
def test_attention_kernel_takes_a_view_at_an_odd_offset(cuda_device):
    """TMA needs 16-byte aligned tensors: a contiguous bf16 view that starts
    one element into its storage still runs, and gives the same answer."""
    q, k, v = _attn_inputs(16, 1, 100, 4, 2, 64, torch.bfloat16, cuda_device)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=cuda_device)
    odd = flat[1:].view(q.shape)
    odd.copy_(q)
    assert odd.is_contiguous() and odd.data_ptr() % 16
    out = flash_attention(odd, k, v, causal=True)
    torch.cuda.synchronize()
    assert torch.equal(out, flash_attention(q, k, v, causal=True))


@pytest.mark.cuda
def test_attention_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v = _attn_inputs(8, 1, 64, 4, 2, 64, torch.float32, cuda_device)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)   # q's shape, other strides
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(strided, k, v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="head size"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous())


@pytest.mark.cuda
def test_trainable_wrappers_launch_the_kernels_and_give_oracle_gradients(cuda_device):
    q, k, v = (t.requires_grad_() for t in _attn_inputs(9, 1, 128, 4, 2, 64,
                                                        torch.float32, cuda_device))
    before = flash_attention.launches
    out = flash_attention_trainable(q, k, v, causal=True)
    assert flash_attention.launches == before + 1
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(11),
                    device=cuda_device)
    grads = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True), (q, k, v), g)
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=1e-5)

    inp = {key: val.requires_grad_() if key in ("r", "k", "v", "w") else val
           for key, val in _wkv_inputs(10, 1, 64, 2, 32, torch.float32, cuda_device).items()}
    before = rwkv6_scan.launches
    y, s = rwkv6_scan_trainable(**inp)
    assert rwkv6_scan.launches == before + 1
    gr = torch.autograd.grad(y.sum(), [inp[key] for key in ("r", "k", "v", "w")])
    yr, _ = rwkv6_ref(**inp)
    want = torch.autograd.grad(yr.sum(), [inp[key] for key in ("r", "k", "v", "w")])
    for got, ref in zip(gr, want):
        np.testing.assert_allclose(_np(got), _np(ref), atol=1e-5, rtol=1e-5)


def _decode_inputs(seed, B, C, Hq, Hk, D, dtype, device, lengths):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device).to(dtype)

    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    return t(B, Hq, D), t(B, C, Hk, D), t(B, C, Hk, D), lens


# (B, C, Hq, Hk, D, lengths): the JAX sweep's shapes, GQA at the serving
# shape, MHA, MQA, ragged C (not a multiple of the 64-slot tile), lengths 1
# and C, and one slot of cache
DECODE_CASES = [
    (2, 512, 8, 2, 64, [1, 512]),
    (3, 256, 4, 4, 128, [100, 256, 1]),
    (1, 1024, 16, 1, 64, [777]),
    (2, 256, 8, 8, 32, [256, 65]),
    (8, 1024, 32, 8, 128, [65, 129, 81, 201, 513, 17, 34, 257]),
    (2, 1000, 8, 1, 128, [1000, 999]),        # MQA, ragged C
    (1, 70, 4, 4, 64, [70]),                  # MHA, ragged C
    (2, 33, 8, 2, 32, [1, 33]),
    (1, 1, 2, 1, 128, [1]),
    (4, 1000, 32, 8, 128, [1, 1000, 999, 517]),   # the serving heads: lengths 1, C, ragged
    (2, 300, 40, 2, 64, [300, 130]),          # g=20: head chunks, the last partial
    # the MoE serving path's decode (g=1: one head in 16 mma rows) at its
    # first step's lengths, and command-r-plus's g=12
    (8, 1024, 16, 16, 128, [65, 129, 81, 201, 513, 17, 34, 257]),
    (4, 1024, 96, 8, 128, [1, 1024, 700, 33]),
    # RecurrentGemma's decode (MQA, g=16 fills the 16 mma rows, D=256) at its
    # first step's lengths, past the ring's wrap (every slot valid), a ragged
    # C and two kv heads
    (8, 1024, 16, 1, 256, [65, 129, 81, 201, 513, 17, 34, 257]),
    (1, 2048, 16, 1, 256, [2048]),
    (3, 100, 16, 1, 256, [1, 100, 37]),
    (2, 300, 32, 2, 256, [300, 64]),
    # Whisper's decoder decode (MHA, g=1, D=64) over its 448-slot self cache,
    # and Qwen2-VL's (g=8, D=128) at the serving shape's first-step lengths
    (8, 448, 6, 6, 64, [64, 1, 448, 200, 5, 300, 447, 33]),
    (8, 1024, 64, 8, 128, [65, 129, 81, 201, 513, 17, 34, 257]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hk,D,lengths", DECODE_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(cuda_device, B, C, Hq, Hk, D, lengths, dtype):
    q, k, v, lens = _decode_inputs(11, B, C, Hq, Hk, D, dtype, cuda_device, lengths)
    before = flash_decode.launches
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert flash_decode.launches == before + 1
    ref = decode_attention_ref(q, k, v, lens)
    assert out.dtype == dtype and out.shape == q.shape
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hk,D", [(66000, 3, 2, 1, 32), (1, 3, 70000, 70000, 32)])
def test_decode_kernel_takes_any_batch_and_kv_heads(cuda_device, B, C, Hq, Hk, D):
    """B and Hk past the 65535 of one grid axis."""
    lengths = np.random.default_rng(18).integers(1, C + 1, B).tolist()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, lens = _decode_inputs(18, B, C, Hq, Hk, D, dtype, cuda_device, lengths)
        out = flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        ref = decode_attention_ref(q, k, v, lens)
        np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[dtype])


@pytest.mark.cuda
def test_decode_kernel_replays_in_a_cuda_graph(cuda_device):
    """One launch a call, no allocation and no host sync: the call is captured
    in a CUDA graph, and two replays on new inputs give the eager outputs.
    The eager calls share one stream's scratch, which needs the merge
    counters to reset themselves."""
    B, C, Hq, Hk, D = 8, 1024, 32, 8, 128
    q, k, v, lens = _decode_inputs(19, B, C, Hq, Hk, D, torch.bfloat16, cuda_device,
                                   [1024, 65, 300, 1, 777, 1024, 512, 129])
    flash_decode(q, k, v, lens)               # builds and sizes the scratch
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    before = flash_decode.launches
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, lens)
    assert flash_decode.launches == before + 1
    for seed in (20, 21):
        q2, k2, v2, _ = _decode_inputs(seed, B, C, Hq, Hk, D, torch.bfloat16, cuda_device,
                                       [1] * B)
        for dst, src in ((q, q2), (k, k2), (v, v2)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        eager = flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
def test_decode_graph_replays_beside_eager_calls_on_another_stream(cuda_device):
    """Replays of a captured call on one stream beside eager calls on other
    inputs on a second stream, each stream's work held back by a sleep
    kernel until both are queued, so their kernels run at once: the graph
    and the eager calls have their own split scratch, so each gives its own
    inputs' output."""
    B, C, Hq, Hk, D = 8, 1024, 32, 8, 128
    q, k, v, lens = _decode_inputs(22, B, C, Hq, Hk, D, torch.bfloat16, cuda_device, [C] * B)
    q2, k2, v2, lens2 = _decode_inputs(23, B, C, Hq, Hk, D, torch.bfloat16, cuda_device,
                                       [C, 700, 1, 513, C, 64, 999, 300])
    want, want2 = flash_decode(q, k, v, lens), flash_decode(q2, k2, v2, lens2)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, lens)
    side1, side2 = torch.cuda.Stream(), torch.cuda.Stream()
    got, got2 = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        for side in (side1, side2):
            with torch.cuda.stream(side):
                torch.cuda._sleep(20_000_000)      # about 10 ms
        for _ in range(20):
            with torch.cuda.stream(side1):
                graph.replay()
                got.append(out.clone())
            with torch.cuda.stream(side2):
                got2.append(flash_decode(q2, k2, v2, lens2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, want) for a in got)
    assert all(torch.equal(a, want2) for a in got2)


@pytest.mark.cuda
def test_decode_kernel_reads_no_slot_past_the_length(cuda_device):
    q, k, v, lens = _decode_inputs(12, 2, 300, 8, 2, 64, torch.float32, cuda_device, [100, 257])
    out = flash_decode(q, k, v, lens)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate((100, 257)):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    out2 = flash_decode(q, k2, v2, lens)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


@pytest.mark.cuda
def test_decode_kernel_rejects_what_it_does_not_take(cuda_device):
    q, k, v, lens = _decode_inputs(13, 2, 128, 8, 2, 64, torch.float32, cuda_device, [5, 9])
    before = flash_decode.launches
    with pytest.raises(TypeError):
        flash_decode(q.half(), k.half(), v.half(), lens)
    with pytest.raises(TypeError):
        flash_decode(q, k.to(torch.bfloat16), v, lens)
    with pytest.raises(ValueError, match="head size"):
        flash_decode(q[..., :48].contiguous(), k[..., :48].contiguous(),
                     v[..., :48].contiguous(), lens)
    with pytest.raises(ValueError, match="multiple"):
        flash_decode(q[:, :7].contiguous(), k, v, lens)
    with pytest.raises(ValueError, match="lengths"):
        flash_decode(q, k, v, lens.long())
    with pytest.raises(ValueError, match="contiguous"):
        flash_decode(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens)
    with pytest.raises(ValueError, match="on"):
        flash_decode(q, k, v, lens.cpu())
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode(q.cpu(), k.cpu(), v.cpu(), lens.cpu())
    assert flash_decode.launches == before


FLOAT8 = [torch.float8_e4m3fn, torch.float8_e5m2]
# (B, C, Hq, Hk, D, lengths): float8 K/V at every head size the kernel takes,
# among them the dense serving shape and the hybrid's (g = 16, D = 256)
FLOAT8_CASES = [
    (2, 300, 8, 2, 32, [300, 65]),
    (8, 448, 6, 6, 64, [64, 1, 448, 200, 5, 300, 447, 33]),
    (8, 1024, 32, 8, 128, [65, 129, 81, 201, 513, 17, 34, 257]),
    (4, 1000, 32, 8, 128, [1, 1000, 999, 517]),
    (8, 1024, 16, 1, 256, [65, 129, 81, 201, 513, 17, 34, 257]),
    (1, 2048, 16, 1, 256, [2048]),
]


def _float8_inputs(seed, B, C, Hq, Hk, D, dtype, kv_dtype, device, lengths):
    q, k, v, lens = _decode_inputs(seed, B, C, Hq, Hk, D, torch.float32, device, lengths)
    return q.to(dtype), astype(k, kv_dtype), astype(v, kv_dtype), lens


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hk,D,lengths", FLOAT8_CASES)
@pytest.mark.parametrize("kv_dtype", FLOAT8)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_on_float8_kv_matches_plain_version(cuda_device, B, C, Hq, Hk, D, lengths,
                                                          kv_dtype, dtype):
    """A float8 cache read as it is stored: the kernel against the plain
    version, which widens K/V to q's dtype first; one float8 launch."""
    q, k, v, lens = _float8_inputs(31, B, C, Hq, Hk, D, dtype, kv_dtype, cuda_device, lengths)
    key = (dtype, kv_dtype)
    before, before8 = flash_decode.launches, flash_decode.kind_launches.get(key, 0)
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode.kind_launches[key]) == (before + 1, before8 + 1)
    assert out.dtype == dtype and out.shape == q.shape
    ref = decode_attention_ref(q, k, v, lens)
    assert torch.equal(ref, decode_attention_ref(q, k.to(dtype), v.to(dtype), lens))
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[dtype])



# (q dtype, K/V dtype): the other float K/V dtypes the kernel converts in
# shared memory (a cache in another kv_dtype than the model's)
KV_KINDS = [(torch.float32, torch.bfloat16), (torch.float32, torch.float16),
            (torch.bfloat16, torch.float32), (torch.bfloat16, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,Hq,Hk,D,lengths", FLOAT8_CASES)
@pytest.mark.parametrize("dtype,kv_dtype", KV_KINDS)
def test_decode_kernel_on_other_kv_dtypes_matches_plain_version(cuda_device, B, C, Hq, Hk, D,
                                                                lengths, dtype, kv_dtype):
    """K/V in another float dtype than q's, at every head size: the kernel
    against the plain version, which casts K/V to q's dtype first (a
    narrowing to bf16 rounded to nearest even); one launch of that kind."""
    q, k, v, lens = _decode_inputs(36, B, C, Hq, Hk, D, torch.float32, cuda_device, lengths)
    q, k, v = q.to(dtype), astype(k, kv_dtype), astype(v, kv_dtype)
    key = (dtype, kv_dtype)
    before = (flash_decode.launches, flash_decode.kind_launches.get(key, 0))
    out = ops.decode_attention(q, k, v, lens)
    torch.cuda.synchronize()
    assert (flash_decode.launches, flash_decode.kind_launches[key]) == (before[0] + 1,
                                                                        before[1] + 1)
    assert out.dtype == dtype and out.shape == q.shape
    ref = decode_attention_ref(q, k, v, lens)
    assert torch.equal(ref, decode_attention_ref(q, astype(k, dtype), astype(v, dtype), lens))
    np.testing.assert_allclose(_np(out), _np(ref), **ATTN_TOL[dtype])

@pytest.mark.cuda
def test_float8_decode_replays_in_a_cuda_graph(cuda_device):
    """A float8 call captured in a CUDA graph: replays on new inputs give
    the eager outputs."""
    B, C, Hq, Hk, D = 8, 1024, 32, 8, 128
    lengths = [1024, 65, 300, 1, 777, 1024, 512, 129]
    q, k, v, lens = _float8_inputs(32, B, C, Hq, Hk, D, torch.bfloat16, torch.float8_e4m3fn,
                                   cuda_device, lengths)
    flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_decode(q, k, v, lens)
    for seed in (33, 34):
        q2, k2, v2, _ = _float8_inputs(seed, B, C, Hq, Hk, D, torch.bfloat16,
                                       torch.float8_e4m3fn, cuda_device, lengths)
        q.copy_(q2)
        k.view(torch.uint8).copy_(k2.view(torch.uint8))
        v.view(torch.uint8).copy_(v2.view(torch.uint8))
        graph.replay()
        torch.cuda.synchronize()
        eager = flash_decode(q, k, v, lens)
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", FLOAT8)
def test_float8_cast_on_the_card_is_the_cpu_cast(cuda_device, kv_dtype):
    """The cast a float8 cache is written through gives on the card the
    bytes it gives on the CPU (held there against ``jnp.astype``) for all
    65536 bf16 patterns and a float32 sweep across float8_e4m3fn's range."""
    bits = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16)
    x16 = bits.view(torch.bfloat16)
    x32 = torch.cat([torch.linspace(-500, 500, 200001), torch.linspace(57000, 62000, 5001),
                     torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf")])])
    for x in (x16, x32):
        got = astype(x.to(cuda_device), kv_dtype).view(torch.uint8).cpu()
        assert torch.equal(got, astype(x, kv_dtype).view(torch.uint8))


@pytest.mark.cuda
def test_decode_kernel_rejects_mixed_kv_dtypes(cuda_device):
    """K and V share one dtype, q's or one float8; q is never float8."""
    q, k, v, lens = _float8_inputs(35, 2, 128, 8, 2, 64, torch.bfloat16, torch.float8_e4m3fn,
                                   cuda_device, [5, 9])
    before = flash_decode.launches
    for kk, vv in ((k.to(torch.bfloat16), v), (k, v.to(torch.bfloat16)),
                   (k, astype(v.float(), torch.float8_e5m2))):
        with pytest.raises(TypeError, match="share one dtype"):
            check_decode_args(q, kk, vv, lens)
        with pytest.raises(TypeError):
            flash_decode(q, kk, vv, lens)
    with pytest.raises(TypeError, match="q must be"):
        flash_decode(q.to(torch.float8_e4m3fn), k, v, lens)
    assert flash_decode.launches == before


def _decision_inputs(seed, G, D):
    """Decision-kernel inputs on the host: integer-valued totals and queues
    in half the rows (exact ties), +inf totals, a wholly infeasible row, a
    row with one feasible device and a feasible row of +inf totals."""
    rng = np.random.default_rng(seed)
    total = rng.uniform(0.0, 50.0, (G, D))
    total[: G // 2] = rng.integers(1, 30, (G // 2, D))
    total[rng.random((G, D)) < 0.02] = np.inf
    total[3] = np.inf
    queue = rng.integers(0, 4, (G, D)).astype(np.float64)
    feasible = rng.random((G, D)) < 0.85
    feasible[0] = False
    feasible[1] = False
    feasible[1, D - 1] = True
    sizes = feasible.sum(axis=1)
    before = np.cumsum(sizes > 0) - (sizes > 0)
    targets = np.where(sizes > 0, (7 + before) % np.maximum(sizes, 1), 0)
    return dict(total=total, pf=rng.random((G, D)), queue=queue, feasible=feasible,
                tiers=rng.integers(0, 3, D), targets=targets)


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(8, 24), (33, 300), (256, 5000)])
def test_decision_kernels_match_plain_versions_bit_for_bit(cuda_device, G, D):
    """The four float64 decision kernels and the stable queue selection on
    the card equal their plain numpy versions exactly (ties to the lowest
    device id, first minimum of rows all +inf)."""
    h = _decision_inputs(G * 1000 + D, G, D)
    d = {key: torch.from_numpy(val).to(cuda_device) for key, val in h.items()}
    alpha, beta, gamma = 0.4, 0.08, 3
    k = min(gamma + 1, D - 1) + 1
    masked = np.where(h["feasible"], h["total"], np.inf)
    order = batched.select_queue(torch.from_numpy(masked).to(cuda_device), k).cpu().numpy()
    assert np.array_equal(order, batched.select_queue_plain(masked, k))
    s_total = np.take_along_axis(h["total"], order, 1)
    s_pf = np.take_along_axis(h["pf"], order, 1)
    n_feas = h["feasible"].sum(axis=1)
    got = batched.ibdash_scan_kernel(
        torch.from_numpy(s_total).to(cuda_device), torch.from_numpy(s_pf).to(cuda_device),
        torch.from_numpy(n_feas).to(cuda_device), alpha, beta, gamma).cpu().numpy()
    with np.errstate(invalid="ignore"):
        assert np.array_equal(got, batched.ibdash_scan_plain(s_total, s_pf, n_feas,
                                                             alpha, beta, gamma))
    assert np.array_equal(batched.lavea_kernel(d["queue"], d["feasible"]).cpu().numpy(),
                          batched.lavea_plain(h["queue"], h["feasible"]))
    assert np.array_equal(
        batched.round_robin_kernel(d["feasible"], d["targets"]).cpu().numpy(),
        batched.round_robin_plain(h["feasible"], h["targets"]))
    for budget in (10.0, np.inf):
        assert np.array_equal(
            batched.tier_escalation_kernel(d["total"], d["feasible"], d["tiers"], budget,
                                           3).cpu().numpy(),
            batched.tier_escalation_plain(h["total"], h["feasible"], h["tiers"], budget, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("alpha", [0.3, 0.5, 0.7])
def test_scan_kernel_rounds_as_numpy_at_exact_ties_on_the_card(cuda_device, alpha):
    """Rows whose first replica candidate sits at line 34's exact tie: only
    the rounding of the weight update decides, so a fused multiply-add on
    the card would flip some of them."""
    rng = np.random.default_rng(int(alpha * 10))
    G, K = 4096, 5
    best = rng.uniform(0.5, 3.0, G)
    ratio = 1 + rng.integers(1, 20, (G, K - 1)) / 64
    comb0 = rng.uniform(0.3, 0.9, G)
    pf1 = 1 - alpha * (ratio[:, 0] - 1) / ((1 - alpha) * comb0)
    s_total = np.concatenate([best[:, None], best[:, None] * ratio], axis=1)
    s_pf = np.clip(np.concatenate([comb0[:, None], pf1[:, None],
                                   rng.uniform(0, 1, (G, K - 2))], axis=1), 0.0, 1.0)
    n_feas = np.full(G, K)
    want = batched.ibdash_scan_plain(s_total, s_pf, n_feas, alpha, 0.1, 3)
    assert 0 < want[:, 0].sum() < G
    got = batched.ibdash_scan_kernel(
        *(torch.from_numpy(a).to(cuda_device) for a in (s_total, s_pf, n_feas)),
        alpha, 0.1, 3)
    assert np.array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_argmin_and_stable_sort_tie_breaks_on_the_card(cuda_device):
    """What the decision kernels rely on: argmin takes the first minimum, of
    a row all +inf too; argmax takes a uint8 mask's first 1; the stable sort
    keeps equal keys in ascending index order."""
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [np.inf] * 4, [5.0, 5.0, 5.0, 5.0]],
                     dtype=torch.float64, device=cuda_device)
    assert torch.argmin(x, dim=1).tolist() == [1, 0, 0]
    m = torch.tensor([[0, 1, 1], [0, 0, 0]], dtype=torch.uint8, device=cuda_device)
    assert torch.argmax(m, dim=1).tolist() == [1, 0]
    keys = torch.tensor([[2.0, 1.0, 2.0, 1.0, np.inf, 1.0, np.inf]] * 2, dtype=torch.float64,
                        device=cuda_device)
    assert torch.sort(keys, dim=1, stable=True).indices[0].tolist() == [1, 3, 5, 0, 2, 4, 6]
    wide = torch.zeros(1, 100_000, dtype=torch.float64, device=cuda_device)
    assert torch.equal(torch.sort(wide, dim=1, stable=True).indices[0],
                       torch.arange(100_000, device=cuda_device))


@pytest.mark.cuda
def test_admitted_stream_run_is_the_same_on_card_and_cpu(cuda_device):
    """A small admitted streaming-service run through the port plans the
    same on the card as on the CPU: records, shed log, counters and every
    metric but the two read off the host's clock."""
    import dataclasses
    import json

    from repro_torch.api import SimConfig, run_one
    from repro_torch.stream import without_wall_clock

    def run(device):
        res = run_one("ibdash", SimConfig(
            scenario="stream", device=device, n_devices=24, n_cycles=1, cycle_len=10.0,
            stream_rate=60.0, stream_queue_cap=40, stream_wave=8))
        s = res.stream
        return ([dataclasses.astuple(r) for r in res.instances], s.stats,
                [dataclasses.astuple(r) for r in s.shed_log],
                json.dumps(without_wall_clock(s.metrics), sort_keys=True))

    got, want = run("cuda"), run("cpu")
    assert got == want
    assert got[1]["shed"] > 0


def _meta_and_card_calls(device):
    """One call of each kernel's entry point (attention through its trainable
    form, forward and backward; decode; WKV through its trainable form) on
    ``device``; returns the launch counts they added."""
    before = (flash_attention.launches, flash_decode.launches, rwkv6_scan.launches)
    q = torch.zeros((1, 64, 4, 64), dtype=torch.bfloat16, device=device, requires_grad=True)
    k = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=device, requires_grad=True)
    out = flash_attention_trainable(q, k, k)
    out.float().sum().backward()
    lengths = torch.full((1,), 64, dtype=torch.int32, device=device)
    d = ops.decode_attention(q[:, 0].detach().contiguous(), k.detach(), k.detach(), lengths)
    r = torch.zeros((1, 64, 2, 64), dtype=torch.bfloat16, device=device, requires_grad=True)
    w = torch.full((1, 64, 2, 64), 0.5, device=device, requires_grad=True)
    y, s = rwkv6_scan_trainable(r, r, r, w, torch.zeros((2, 64), device=device),
                                torch.zeros((1, 2, 64, 64), device=device))
    (y.float().sum() + s.sum()).backward()
    assert out.shape == q.shape and d.shape == (1, 4, 64) and y.shape == r.shape
    assert out.device.type == y.device.type == torch.device(device).type
    return (flash_attention.launches - before[0], flash_decode.launches - before[1],
            rwkv6_scan.launches - before[2])


def test_meta_tensors_take_no_kernel_launch():
    """The dry-run's route: meta tensors get meta outputs and counted work,
    and neither a launch nor a build (there is no card here)."""
    from repro_torch.kernels.meta import count_kernel_work

    with count_kernel_work() as work:
        assert _meta_and_card_calls("meta") == (0, 0, 0)
    assert work.calls == {"flash_attention": 1, "flash_decode": 1, "rwkv6_scan": 1,
                          "rwkv6_scan backward": 1}


@pytest.mark.cuda
def test_cuda_tensors_still_launch_the_kernels(cuda_device):
    assert _meta_and_card_calls(cuda_device) == (1, 1, 1)
