"""The head's product (``LM.logits`` through ``models.layers.head_product``).

On the CPU: the exact three-way bf16 split of a float32 matrix
(``ops.split_bf16``), bit for bit over float32's exponents; ``HeadProduct``
forced on the CPU with its emulated product (the operands cast up, each
product exact) against the upcast route's autograd, alone and inside a
model's loss and gradients; the route each call takes and its counter.

On a card (``-m cuda``): the split kernel bit for bit against its plain
version; ``HeadProduct`` at Qwen1.5-0.5B's head on one chunk of tokens
against the float32 products; a tiny dense model's graphed decode against
its eager upcast head.  These tests import neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_head_product.py
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import counts, ops
from repro_torch.kernels.bf16_split import bf16_split
from repro_torch.kernels.ref import bf16_split_ref
from repro_torch.models import LM, layers, reduced
from repro_torch.models.layers import HeadProduct, head_product, head_route
from repro_torch.obs import runtime
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.step import value_and_grad

BF16, F32 = torch.bfloat16, torch.float32


def _wide_floats(n, rng, lo_exp=-100, hi_exp=100):
    """float32 values with exponents uniform in [lo_exp, hi_exp], both signs,
    every significand bit random, zeros among them."""
    sig = rng.integers(1 << 23, 1 << 24, n).astype(np.float64)
    exp = rng.integers(lo_exp, hi_exp + 1, n) - 23
    x = np.ldexp(sig, exp) * rng.choice([-1.0, 1.0], n)
    x[rng.random(n) < 0.02] = 0.0
    return torch.from_numpy(x.astype(np.float32))


def _softmax_grads(rows, cols, rng):
    """A cross-entropy's cotangent over random logits: softmax less one-hot,
    values from about 1e-18 to 1."""
    lg = torch.from_numpy(rng.normal(0.0, 6.0, (rows, cols)).astype(np.float32))
    g = torch.softmax(lg, dim=-1)
    g[torch.arange(rows), torch.from_numpy(rng.integers(0, cols, rows))] -= 1.0
    return g


def _assert_exact(g, pieces):
    assert pieces.dtype == BF16 and pieces.shape == (g.shape[0], 3, g.shape[1])
    total = pieces.double().sum(dim=1)
    bad = total != g.double()
    assert not bad.any(), f"{int(bad.sum())} inexact, e.g. {g[bad][:4].tolist()}"


# -- on the CPU ------------------------------------------------------------------------
@pytest.mark.parametrize("values", ["wide", "softmax_grads"])
def test_split_is_exact(values):
    rng = np.random.default_rng(7)
    g = (_wide_floats(64 * 257, rng).view(64, 257) if values == "wide"
         else _softmax_grads(64, 257, rng))
    if values == "softmax_grads":
        nz = g[g != 0].abs()
        assert nz.min() < 1e-17 and nz.max() > 0.5
    pieces = ops.split_bf16(g)
    _assert_exact(g, pieces)
    hi, mid, lo = pieces.unbind(1)
    assert torch.equal(hi, g.to(BF16))                      # the top piece is g rounded
    assert (mid.float().abs() <= hi.float().abs() * 2.0 ** -8).all()
    assert (lo.float().abs() <= mid.float().abs() * 2.0 ** -8).all()


def test_split_of_a_column_block_and_below_its_exact_range():
    """A column block of a wider matrix (the backward's view) splits as the
    block copied out; values under 2^-110 keep lo's error under 2^-133."""
    rng = np.random.default_rng(8)
    wide = _wide_floats(16 * 300, rng).view(16, 300)
    block = wide[:, 40:140]
    assert block.stride() == (300, 1)
    assert torch.equal(ops.split_bf16(block), ops.split_bf16(block.contiguous()))
    _assert_exact(block, ops.split_bf16(block))
    tiny = _wide_floats(4096, rng, -126, -111).view(64, 64)
    err = (bf16_split_ref(tiny).double().sum(dim=1) - tiny.double()).abs()
    assert err.max() <= 2.0 ** -134


def _head_inputs(T, d, V, seed=0, dtype=BF16, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    h = torch.randn(T, d, generator=gen).to(dtype).to(device)
    w = (torch.randn(V, d, generator=gen) * 0.05).to(dtype).to(device).T   # the tied .T view
    y = torch.randint(0, V, (T,), generator=gen).to(device)
    return h, w, y


def _xent(lg, y):
    return torch.nn.functional.cross_entropy(lg.flatten(0, -2), y.flatten())


def _grads(fn, h, w, y):
    h, w = h.detach().requires_grad_(True), w.detach().requires_grad_(True)
    lg = fn(h, w)
    lg_out = lg.detach()
    _xent(lg, y).backward()
    return lg_out, h.grad, w.grad


def _upcast(h, w):
    return h.to(F32) @ w.to(F32)


def _near_bf16(got, want, share):
    """bf16 ``got`` equal to ``want`` in at least ``share`` of its elements,
    every other within one bf16 step of ``want``."""
    assert got.dtype == want.dtype == BF16
    got, want = got.float(), want.float()
    ulp = torch.where(want == 0, torch.tensor(2.0 ** -133),
                      2.0 ** (torch.floor(torch.log2(want.abs())) - 7))
    assert ((got - want).abs() <= ulp).all()
    assert (got == want).float().mean() >= share


@pytest.mark.parametrize("split_bytes", [1 << 30, 6 * 24 * 64])   # one block; blocks of 64
def test_function_equals_the_upcast_autograd(monkeypatch, split_bytes):
    """Forward, dh and dw of ``HeadProduct`` (the CPU's emulated products)
    against the cast-then-multiply route's autograd, and both against the
    float64 truth: the backward rounds no cotangent."""
    monkeypatch.setattr(layers, "HEAD_SPLIT_BYTES", split_bytes)
    h, w, y = _head_inputs(24, 48, 200)
    lg, gh, gw = _grads(HeadProduct.apply, h, w, y)
    lg0, gh0, gw0 = _grads(_upcast, h, w, y)
    assert lg.dtype == F32 and gh.dtype == gw.dtype == BF16
    torch.testing.assert_close(lg, lg0, rtol=1e-6, atol=1e-6)
    _near_bf16(gh, gh0, 0.98)
    _near_bf16(gw, gw0, 0.98)
    # the truth: the same float32 cotangent through float64 products
    g = (torch.softmax(lg0.double(), -1) - torch.nn.functional.one_hot(y, 200)) / len(y)
    _near_bf16(gh, (g @ w.double().T).to(BF16), 0.98)
    _near_bf16(gw, (h.double().T @ g).to(BF16), 0.98)


def test_a_rounded_cotangent_would_fail_the_truth():
    """The control of the test above: a backward that rounds the cotangent
    to bf16 misses the float64 truth in far more elements."""
    h, w, y = _head_inputs(24, 48, 200)
    lg = _upcast(h, w)
    g = (torch.softmax(lg.double(), -1) - torch.nn.functional.one_hot(y, 200)) / len(y)
    rounded = g.to(F32).to(BF16).double()
    want, got = (h.double().T @ g).to(BF16), (h.double().T @ rounded).to(BF16)
    assert (got == want).float().mean() < 0.9


def test_model_loss_and_gradients_through_the_function(monkeypatch):
    """A tiny bf16 model with its head forced through ``HeadProduct`` on the
    CPU: the loss, and every gradient leaf within bf16's rounding of the
    upcast route's."""
    cfg = reduced(get_config("qwen1.5-0.5b"), dtype="bfloat16")
    model = LM(cfg, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    ids = torch.randint(0, cfg.vocab, (2, 17), generator=gen)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    before = dict(head_product.routes)
    loss0, _, g0 = value_and_grad(model, params, batch)
    assert head_product.routes["upcast"] == before["upcast"] + 1
    monkeypatch.setattr(layers, "head_route", lambda *a: "tensor_core")
    loss1, _, g1 = value_and_grad(model, params, batch)
    assert head_product.routes["tensor_core"] == before["tensor_core"] + 1
    torch.testing.assert_close(loss1, loss0, rtol=1e-6, atol=0)
    for a, b in zip(torch.utils._pytree.tree_leaves(g1), torch.utils._pytree.tree_leaves(g0)):
        assert a.dtype == b.dtype and a.shape == b.shape
        # the head's bf16 gradients may differ by a step where the sums' order
        # moves a rounding; what flows back from them moves as little
        assert (a.float() - b.float()).norm() <= 2 ** -6 * b.float().norm()


def test_upcast_route_equals_autograd_through_the_casts():
    """The upcast route of 16-bit operands: the logits and both gradients
    bit for bit those of autograd through ``h.to(f32) @ w.to(f32)``, and no
    float32 copy of an operand saved between the passes."""
    h, w, y = _head_inputs(24, 48, 200)
    h = h.view(2, 12, 48)
    lg, gh, gw = _grads(lambda a, b: head_product(a, b, F32), h, w, y.view(2, 12))
    lg0, gh0, gw0 = _grads(_upcast, h, w, y.view(2, 12))
    assert torch.equal(lg, lg0) and torch.equal(gh, gh0) and torch.equal(gw, gw0)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        head_product(h.requires_grad_(True), w.requires_grad_(True), F32)
    assert saved and all(t.dtype == BF16 for t in saved)


@pytest.mark.parametrize("case", ["cpu", "meta", "float32", "bf16_logits"])
def test_routes_off_the_card_are_upcast(case):
    dtype = F32 if case == "float32" else BF16
    out = BF16 if case == "bf16_logits" else F32
    device = "meta" if case == "meta" else "cpu"
    h, w, _ = _head_inputs(4, 8, 16, dtype=dtype)
    h, w = h.to(device), w.to(device)
    before = counts.snapshot()
    lg = head_product(h[None], w, out)
    assert head_route(h, w, out) == "upcast"
    assert lg.shape == (1, 4, 16) and lg.dtype == out and lg.device.type == device
    assert counts.since(before)[("head_product", "routes")] == {"upcast": 1}


def test_route_needs_a_card_16_bit_operands_and_float32_logits():
    def t(dtype, cuda=True):
        return SimpleNamespace(is_cuda=cuda, dtype=dtype)

    F16 = torch.float16
    assert head_route(t(BF16), t(BF16), F32) == "tensor_core"
    assert head_route(t(F16), t(F16), F32) == "tensor_core"
    for h, w, out in ((t(BF16, False), t(BF16), F32), (t(BF16), t(F16), F32),
                      (t(F32), t(F32), F32), (t(BF16), t(BF16), BF16), (t(F16), t(BF16), F32)):
        assert head_route(h, w, out) == "upcast"


def test_the_logits_span_carries_the_route():
    cfg = reduced(get_config("qwen1.5-0.5b"), dtype="bfloat16")
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    runtime.drain()
    runtime.enable()
    try:
        model.logits(params, torch.zeros(1, 3, cfg.d_model, dtype=BF16))
        spans = runtime.drain()
    finally:
        runtime.disable()
    (sp,) = [s for s in spans if s.kind == "model.logits"]
    assert sp.attrs["route"] == "upcast"


def test_kernel_wrapper_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="CUDA kernel"):
        bf16_split(torch.zeros(2, 4))


# -- on a card ------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with CUDA")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cols,start", [(4096, 0), (1001, 0), (1000, 3)])
def test_split_kernel_equals_its_plain_version(cuda_device, cols, start):
    """The vector path (rows 16-byte aligned), the scalar path (an odd row
    length), a column block at an odd offset: bit for bit, and exact."""
    rng = np.random.default_rng(cols + start)
    wide = _wide_floats(256 * (cols + start + 8), rng).view(256, cols + start + 8)
    g = wide[:, start:start + cols].to(cuda_device)
    before = bf16_split.launches
    got = ops.split_bf16(g)
    torch.cuda.synchronize()
    assert bf16_split.launches == before + 1
    assert torch.equal(got.cpu(), bf16_split_ref(g.cpu()))
    _assert_exact(g.cpu(), got.cpu())


@pytest.mark.cuda
def test_function_at_qwen_head_shape(cuda_device):
    """One chunk of Qwen1.5-0.5B's tied head (T = 2048, d = 1024, V =
    151,936) on the tensor cores against the float32 SIMT products, both fed
    one cross-entropy cotangent: logits within 1e-5 of the row's largest;
    dh and dw in bf16 equal the float32 path's in 99.5% of their elements
    and bf16(float64 truth) in as many, and every element within one bf16
    step of the truth plus 2^-20 of its terms' absolute sum (what float32
    sums of these lengths keep; the tensor cores' accumulation over a
    contraction much longer than ``HEAD_MAX_K`` breaks it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    T, V = 2048, 151936
    h0, w0, y = _head_inputs(T, 1024, V, device=cuda_device)
    with torch.no_grad():
        lg0 = _upcast(h0, w0)
        g = torch.softmax(lg0, -1)
        g[torch.arange(T, device=cuda_device), y] -= 1.0
        g /= T

    def grads(fn):
        h, w = h0.detach().requires_grad_(True), w0.detach().requires_grad_(True)
        lg = fn(h, w)
        lg.backward(g)
        return lg.detach(), h.grad, w.grad

    before = head_product.routes["tensor_core"]
    lg, gh, gw = grads(lambda a, b: head_product(a, b, F32))
    assert head_product.routes["tensor_core"] == before + 1
    _, gh0, gw0 = grads(_upcast)
    scale = lg0.abs().amax(dim=-1, keepdim=True)
    assert ((lg - lg0).abs() / scale).max().item() <= 1e-5
    rows = torch.arange(0, T, 16, device=cuda_device)
    cols = torch.arange(0, V, 37, device=cuda_device)
    gd, hd, wd = g.double(), h0.double(), w0.double()
    cases = ((gh[rows], gh0[rows], gd[rows] @ wd.T, gd[rows].abs() @ wd.abs().T),
             (gw[:, cols], gw0[:, cols], hd.T @ gd[:, cols], hd.abs().T @ gd[:, cols].abs()))
    for got, f32, truth, terms in cases:
        got, f32 = got.double(), f32.double()
        assert (got == f32).double().mean() >= 0.995
        assert (got == truth.to(BF16).double()).double().mean() >= 0.995
        ulp = 2.0 ** (torch.floor(torch.log2(truth.abs().clamp_min(1e-38))) - 7)
        assert ((got - truth).abs() <= ulp + 2.0 ** -20 * terms).all()


@pytest.mark.cuda
def test_graphed_decode_gives_the_eager_upcast_tokens(cuda_device):
    """A tiny bf16 dense model served through its captured step (the head on
    the tensor cores) against an eager twin (a ``decode_fn`` hook keeps its
    step eager) whose head casts up: the same tokens over 16 steps; the
    warm-up step and each replay count one tensor-core product."""
    cfg = reduced(get_config("qwen1.5-0.5b"), dtype="bfloat16")
    model = LM(cfg, device=cuda_device)
    twin = LM(cfg, device=cuda_device, decode_fn=ops.decode_attention)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(5))
    w, _ = model._head(params)
    twin.logits = lambda p, hid: _upcast(hid, w)
    prompts = [[3, 14, 15, 92, 65], [35, 89, 79, 32, 38, 46, 26]]

    def serve(m):
        eng = ServingEngine(m, params, max_batch=2, max_seq=64)
        for i, p in enumerate(prompts):
            eng.add_request(f"r{i}", p, 17)
        before = dict(head_product.routes)
        for _ in range(16):
            eng.step()
        delta = {k: n - before[k] for k, n in head_product.routes.items()}
        return [st.generated for st in eng.slots], delta, eng

    toks, delta, eng = serve(model)
    assert (eng.captures, eng.replays) == (1, 15)
    assert delta == {"tensor_core": 16, "upcast": 0}
    toks0, delta0, eng0 = serve(twin)
    assert (eng0.captures, eng0.replays) == (0, 0) and delta0 == {"tensor_core": 0, "upcast": 0}
    assert toks == toks0
