"""The dry-run's memory proof (``repro_torch.memtrace.LiveBytes``;
``repro_torch.launch.dryrun``: ``update_temps``, ``cell_memory``; the
kernels' meta route in ``repro_torch.kernels.meta``) held against the CPU and against counts made
by hand.

A meta cell's traced live bytes must equal those of the same step run on
the CPU with real tensors under the same tracker, to the byte, and, run
with no tracker at all, the allocations ``torch.profiler`` records on the
CPU (the tracker's dispatch mode, and meta tensors, send autograd down its
out-of-place paths for tensor subclasses; the tracker undoes them as a
card runs them).  On the CPU each kernel's route is its meta route's
buffers (what its CUDA wrapper allocates) on CPU tensors: the plain
version's values copied in from outside the trace, or zeros where the
profiler would see the plain version's own allocations.  The optimizer's
update, priced from two cut slices of each leaf, must equal a sliced CPU
update's peak, to the byte.
"""
import dataclasses
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec
from repro_torch.data.synthetic import materialize_batch
from repro_torch.kernels import meta
from repro_torch.kernels.flash_decode import call_plan
from repro_torch.kernels import ref as ref_module
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh
from repro_torch import memtrace
from repro_torch.memtrace import LiveBytes
from repro_torch.models import LM, reduced
from repro_torch.optim import optimizers
from repro_torch.train.step import make_train_step
from repro_torch.tree import tree_flatten, tree_unflatten

ONE = AbstractMesh((1, 1), ("data", "model"))
SINGLE = AbstractMesh((4, 2), ("data", "model"))
POD_MESH = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
ARCH_GRID = ["olmo-1b", "rwkv6-3b", "qwen2-moe-a2.7b", "deepseek-v3-671b", "recurrentgemma-9b",
             "whisper-tiny", "qwen2-vl-72b"]
KINDS = {"train_4k": "train", "prefill_32k": "prefill", "decode_32k": "decode"}


def _small(monkeypatch, S):
    shapes = {name: ShapeSpec(name, kind, S, 2) for name, kind in KINDS.items()}
    for name, spec in shapes.items():
        monkeypatch.setitem(SHAPES, name, spec)
    return shapes


def _kernel_routes(monkeypatch, values=True):
    """The CPU routes of the three kernels allocate as their CUDA wrappers
    do (the meta route's buffers, on the CPU), filled with the plain
    version's values computed outside the trace, or zeroed."""
    def like(plain, route):
        def run(*args, **kw):
            got = route(*args, **kw)
            outs = got if isinstance(got, tuple) else (got,)
            if values:
                with _disable_current_modes():
                    want = plain(*args, **kw)
                for g, w in zip(outs, want if isinstance(want, tuple) else (want,)):
                    g.copy_(w)
            else:
                for g in outs:
                    g.zero_()
            return got
        return run

    monkeypatch.setattr(ref_module, "attention_ref", like(
        ref_module.attention_ref,
        lambda q, k, v, causal=True, window=None: meta.attention(q, k, v, causal, window)))
    monkeypatch.setattr(ref_module, "decode_attention_ref",
                        like(ref_module.decode_attention_ref, meta.decode_attention))
    monkeypatch.setattr(ref_module, "rwkv6_ref", like(ref_module.rwkv6_ref, meta.rwkv6))


def _cpu_cell(cell, cfg, s):
    """The meta cell's step on the CPU: weights drawn from a seed, the
    trainer's batch, a prompt, or one token a row at position 5."""
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cpu = dataclasses.replace(cell, model=model, params=params)
    if s.kind == "decode":
        pos = torch.full((s.global_batch,), 5, dtype=torch.int32)
        cpu.specs = {"tokens": torch.zeros(s.global_batch, dtype=torch.int32), "pos": pos}
        if cfg.needs_position_ids:
            cpu.specs["position_ids"] = pos.expand(3, -1)[..., None].contiguous()
    else:
        mode = "train" if s.kind == "train" else "prefill"
        cpu.specs = {k: torch.from_numpy(v) for k, v in
                     materialize_batch(cfg, s.global_batch, s.seq_len, mode=mode).items()}
    if s.kind == "train":
        cpu.opt_state = cell.optimizer.init(params)
    else:
        cpu.caches = model.init_cache(s.global_batch, s.seq_len)
    return cpu


@pytest.mark.parametrize("remat", ["block", "none"])
@pytest.mark.parametrize("arch", ARCH_GRID)
@pytest.mark.parametrize("shape", list(KINDS))
def test_meta_cell_peak_equals_the_cpu_step(monkeypatch, arch, shape, remat):
    """The traced live bytes of a reduced cell on meta and of its step on
    the CPU, under the same tracker: the same peak, to the byte, and the
    same memory record on one device."""
    s = _small(monkeypatch, 16)[shape]
    cfg = reduced(get_config(arch), remat=remat)
    cell = dryrun.build_cell(arch, shape, cfg=cfg)
    count = dryrun.trace_cell(cell)
    _kernel_routes(monkeypatch)
    cpu = _cpu_cell(cell, cfg, s)
    cpu_count = dryrun.trace_cell(cpu)
    assert count["live"].peak == cpu_count["live"].peak > 0
    mem = dryrun.cell_memory(cell, count, ONE)
    assert mem == dryrun.cell_memory(cpu, cpu_count, ONE)
    assert mem["peak_bytes"] >= count["live"].peak


def _profiled_peak(fn) -> int:
    """The peak of the bytes the CPU allocator hands out while ``fn`` runs,
    above what was allocated before, as ``torch.profiler`` records them."""
    with profile(activities=[ProfilerActivity.CPU], profile_memory=True) as prof:
        fn()
    events = sorted((e.start_ns(), e.nbytes()) for e in prof.profiler.kineto_results.events()
                    if e.name() == "[memory]")
    return int(np.cumsum([n for _, n in events]).max(initial=0))


@pytest.mark.parametrize("arch", ARCH_GRID)
def test_meta_peak_equals_the_untraced_cpu_step(monkeypatch, arch):
    """A reduced cell (S = 64, vocab 4096, remat block: the logits and the
    stream outweigh the weights) on meta against its step on the CPU with no
    tracker, whose allocations the profiler records: the peak above the
    arguments within 64 bytes (the CPU kernels' own scalars), for a train
    step (its update through the card's slices), a prefill and a decode
    step."""
    shapes = _small(monkeypatch, 64)
    _kernel_routes(monkeypatch, values=False)
    for shape, s in shapes.items():
        cfg = reduced(get_config(arch), remat="block", vocab=4096)
        cell = dryrun.build_cell(arch, shape, cfg=cfg)
        mem = dryrun.cell_memory(cell, dryrun.trace_cell(cell), ONE)
        cpu = _cpu_cell(cell, cfg, s)
        if s.kind == "train":
            step = make_train_step(cpu.model, cpu.optimizer)
            run = lambda: step(cpu.params, cpu.opt_state, cpu.specs) and None
        elif s.kind == "prefill":
            run = lambda: torch.no_grad()(cpu.model.prefill)(cpu.params, cpu.specs, cpu.caches)
        else:
            sp = cpu.specs
            run = lambda: torch.no_grad()(cpu.model.decode_step)(
                cpu.params, sp["tokens"], sp["pos"], cpu.caches, sp.get("position_ids"))
        with meta.count_kernel_work():
            truth = _profiled_peak(run)
        traced = mem["peak_bytes"] - mem["argument_size_in_bytes"]
        assert abs(traced - truth) <= 64, (shape, traced, truth)


@pytest.mark.parametrize("update_slice", [1 << 10, 1 << 14, 1 << 24])
@pytest.mark.parametrize("arch,opt", [("olmo-1b", "adamw"), ("qwen2-moe-a2.7b", "adamw"),
                                      ("deepseek-v3-671b", "adafactor"),
                                      ("qwen2-moe-a2.7b", "adafactor"),
                                      ("command-r-plus-104b", "adafactor"),
                                      ("recurrentgemma-9b", "adafactor")])
def test_update_temps_equal_a_sliced_cpu_update(monkeypatch, arch, opt, update_slice):
    """The update's temporaries priced from two cut slices of each leaf
    equal the peak of the whole update on the CPU in slices of
    ``update_slice`` elements, above its parameters, gradients and state,
    to the byte; at 2^10 and 2^14 elements the reduced leaves (six layers)
    span many slices (AdamW's and the full second moment's cut along the first axis,
    Adafactor's stacked matrices cut to two slices' worth and their
    statistics scaled back)."""
    monkeypatch.setattr(optimizers, "UPDATE_SLICE", update_slice)
    cfg = reduced(get_config(arch), dtype="bfloat16", n_layers=6)
    params = LM(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    optimizer = dryrun.pick_optimizer(arch, opt)
    state = optimizer.init(params)
    leaves, structure = tree_flatten(params)
    gen = torch.Generator().manual_seed(1)
    grads = [torch.randn(p.shape, generator=gen).to(p.dtype) for p in leaves]
    cuts = [dryrun._cut_leaf(optimizer, tuple(p.shape), update_slice) for p in leaves]
    if update_slice < 1 << 24:
        assert any(c != (tuple(p.shape), 1) for c, p in zip(cuts, leaves))
    live = LiveBytes()
    with live:
        for t in leaves + grads + tree_flatten(state)[0]:
            live.slot(t)
        base = live.live
        optimizer.update(tree_unflatten(structure, grads), state, params, None)
    live.close()
    upd = dryrun.update_temps(optimizer, leaves)
    assert float(np.cumsum(upd["bytes"]).max(initial=0.0)) == live.peak - base > 0


# ------------------------------------------------ the kernels' meta route --
def test_meta_routes_allocate_the_wrappers_buffers():
    """The WKV route holds the kernel's float32 chunk states (B, H, nch, N,
    N) and decays (B, H, nch, N) beside y and S_T for the call, and the
    decode route the wrapper's split scratch for the trace: at B=2, Hq=4,
    Hk=2, D=32, C=128 in bf16 the plan on 132 SMs is two splits of one
    64-slot tile, 4 rows of 16 heads (one group of g = 2 a block): 4 x 2 x
    16 x 32 float32 partials, 4 x 2 x 16 x 2 (m, l) and 4 int32 counters."""
    B, T, H, N = 2, 40, 3, 16
    r = torch.empty((B, T, H, N), dtype=torch.bfloat16, device="meta")
    w = torch.empty((B, T, H, N), device="meta")
    u, S0 = torch.empty((H, N), device="meta"), torch.empty((B, H, N, N), device="meta")
    live = LiveBytes()
    with live:
        for t in (r, w, u, S0):
            live.slot(t)
        base = live.live
        y, sT = meta.rwkv6(r, r, r, w, u, S0)
    nch = -(-T // meta.wkv_tiling()[0])
    out = B * T * H * N * 2 + B * H * N * N * 4
    assert live.peak - base == out + B * H * nch * N * N * 4 + B * H * nch * N * 4
    assert live.live - base == out

    q = torch.empty((2, 4, 32), dtype=torch.bfloat16, device="meta")
    k = torch.empty((2, 128, 2, 32), dtype=torch.bfloat16, device="meta")
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    live = LiveBytes()
    with meta.count_kernel_work() as work, live:
        meta.decode_attention(q, k, k, lengths)
        meta.decode_attention(q, k, k, lengths)        # the scratch is reused
    scratch = work.scratch[q.device]
    assert (scratch.acc.numel(), scratch.ml.numel(), scratch.counters.numel()) == (
        4 * 2 * 16 * 32, 4 * 2 * 16 * 2, 4)
    assert live.live == (4 * 2 * 16 * 32 + 4 * 2 * 16 * 2) * 4 + 4 * 4


@pytest.mark.parametrize("D,q_dtype,kv_dtype,want", [
    # RecurrentGemma's heads at D = 256: a row's 16 splits are one cluster,
    # which merges in shared memory: no scratch
    pytest.param(256, torch.bfloat16, torch.bfloat16, (0, 0, 0), id="256-kv_dtype0-want0"),
    # the dense serving heads over an f32 cache under a bf16 q: one block an
    # SM, three 384-slot splits of 64 rows (B * Hk) of 16 heads
    pytest.param(128, torch.bfloat16, torch.float32, (64 * 3 * 16 * 128, 64 * 3 * 16 * 2, 64),
                 id="128-kv_dtype1-want1"),
    # an f32 q: the f32 kernel's 16 heads a block, two blocks an SM; the
    # dense heads (g = 4 in one chunk) in four 256-slot splits of 64 rows,
    # over an f32 cache and a bf16 one alike
    (128, torch.float32, torch.float32, (64 * 4 * 16 * 128, 64 * 4 * 16 * 2, 64)),
    (128, torch.float32, torch.bfloat16, (64 * 4 * 16 * 128, 64 * 4 * 16 * 2, 64)),
    # RecurrentGemma's 16 heads in two chunks of 8 under an f32 q: 16 splits
    # of 64 slots of 16 rows, merged from the scratch (no cluster)
    (256, torch.float32, torch.float32, (16 * 16 * 8 * 256, 16 * 16 * 8 * 2, 16)),
])
def test_meta_decode_scratch_is_the_wrappers(D, q_dtype, kv_dtype, want):
    """The decode route on meta allocates the split scratch the CUDA
    wrapper's own plan (``call_plan`` on an H100's SMs) gives, for K/V in
    q's dtype at D = 256, for f32 K/V under a bf16 q, and for an f32 q at
    D = 128 and 256, all counted by hand."""
    B, C, Hk = 8, 1024, 1 if D == 256 else 8
    Hq = 16 * Hk if D == 256 else 32
    q = torch.empty((B, Hq, D), dtype=q_dtype, device="meta")
    k = torch.empty((B, C, Hk, D), dtype=kv_dtype, device="meta")
    lengths = torch.empty((B,), dtype=torch.int32, device="meta")
    with meta.count_kernel_work() as work:
        meta.decode_attention(q, k, k, lengths)
    scratch = work.scratch[q.device]
    got = (scratch.acc.numel(), scratch.ml.numel(), scratch.counters.numel())
    assert got == call_plan(B, Hq, Hk, C, D, q_dtype, kv_dtype, meta.H100_SMS)[2] == want


@pytest.mark.parametrize("g", [1, 16])
def test_softmax_backward_holds_the_cuda_kernels_buffers(monkeypatch, g):
    """The oracle attention backward on meta holds, at its softmax backward,
    the CUDA kernel's own buffers (``memtrace.CUDA_TEMPS``): ``grad *
    output``, and its contiguous copy where the gradient comes permuted
    from the cast of the weights (g > 1): one or two (B, Hk, g, S, S)
    float32 tensors above the trace without them.  The product is laid out
    on meta as on the CPU (``TensorIterator``'s rule)."""
    B, S, Hk, D = 1, 64, 1, 32

    def peak():
        t = [torch.empty(shape, dtype=torch.bfloat16, device="meta")
             for shape in ((B, S, Hk * g, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, Hk * g, D))]
        live = LiveBytes()
        with live, torch.enable_grad():
            for a in t:
                live.slot(a)
            base = live.live
            leaves = [a.detach().requires_grad_() for a in t[:3]]
            out = ref_module.attention_ref(*leaves, causal=True, window=32)
            torch.autograd.grad(out, leaves, t[3])
        live.close()
        return live.peak - base

    with_temps = peak()
    monkeypatch.setattr(memtrace, "CUDA_TEMPS", {})
    assert with_temps - peak() == (1 if g == 1 else 2) * B * Hk * g * S * S * 4
    grad = torch.zeros((B, Hk, S, g, S)).permute(0, 1, 3, 2, 4)
    out = torch.zeros((B, Hk, g, S, S))
    made = memtrace._softmax_backward_temps(grad, out, -1, torch.float32)
    assert made[0].stride() == (grad * out).stride()
    assert len(made) == (1 if g == 1 else 2)


@pytest.mark.parametrize("T", [3, 16, 33])
def test_wkv_backward_peak_extends_by_its_step(T):
    """The oracle WKV backward's peak, traced at 8 and 9 tokens and extended
    by their step, equals the trace at T."""
    args = (2, T, 3, 4, torch.bfloat16)
    assert meta.wkv_backward_peak(*args) == meta._wkv_backward_traced(*args) > 0


# ---------------------------------------------------------- hand counts --
def _one_layer_cell(monkeypatch, kind, remat="none", arch="olmo-1b", seq=16, **overrides):
    name = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}[kind]
    shape = ShapeSpec(name, kind, seq, 8)
    monkeypatch.setitem(SHAPES, shape.name, shape)
    cfg = reduced(get_config(arch), **{"n_layers": 1, "vocab": 128, "dtype": "bfloat16",
                                       "remat": remat, **overrides})
    return dryrun.build_cell(arch, shape.name, cfg=cfg)


def test_memory_counted_by_hand_arguments(monkeypatch):
    """One OLMo layer (its eight leaves 360448 bf16 bytes, each split over
    "data" and "model"), AdamW with bf16 m and v, B=8, S=16: on pod 2 x data
    2 x model 2 a device holds a quarter of the weights (90112), of m and v
    (180224) and the replicated int32 step (4), and of the tokens and labels
    over the batch axes (2 x 512 / 4); the step updates the weights and the
    state in place, as the reference donates them, and returns four float32
    metrics.  On data 4 x model 2 an eighth of each leaf."""
    cell = _one_layer_cell(monkeypatch, "train")
    count = dryrun.trace_cell(cell)
    mem = dryrun.cell_memory(cell, count, POD_MESH)
    assert mem["argument_size_in_bytes"] == 90112 + 180224 + 4 + 256
    assert mem["alias_size_in_bytes"] == 90112 + 180224 + 4
    assert mem["output_size_in_bytes"] == mem["alias_size_in_bytes"] + 4 * 4
    assert (mem["temp_size_in_bytes"] == mem["peak_bytes"] - mem["argument_size_in_bytes"]
            - (mem["output_size_in_bytes"] - mem["alias_size_in_bytes"]))
    single = dryrun.cell_memory(cell, count, SINGLE)
    assert single["argument_size_in_bytes"] == 45056 + 90112 + 4 + 256
    # the largest weight group gathered: the layer's seven matrices
    # (327680 bytes) whole over "data" and "model" on the context-parallel
    # path, beyond a device's quarter, twice (the gradient before its
    # reduce-scatter); without SP over "data" alone
    assert mem["peak_parts"]["gathered"] == 2 * 327680 * 3 / 4
    none = dryrun.cell_memory(cell, count, POD_MESH, "none")
    assert none["peak_parts"]["gathered"] == 2 * 327680 / 4


def test_memory_counted_by_hand_cache(monkeypatch):
    """Prefill and decode write the cache in place (the reference donates
    it): the alias bytes are a device's share of the cache; the arguments
    add the weights and the inputs over the batch axes (a prefill's 8 x 16
    int32 tokens, a decode step's 8 tokens and 8 positions); the prefill
    returns the last position's float32 logits (8 x 128 x 4 bytes, over the
    batch axes and the vocab on "model")."""
    for kind, inputs in (("prefill", 8 * 16 * 4 / 4), ("decode", 2 * 8 * 4 / 4)):
        cell = _one_layer_cell(monkeypatch, kind)
        mem = dryrun.cell_memory(cell, dryrun.trace_cell(cell), POD_MESH)
        res = dryrun.cell_resident(cell, POD_MESH)
        assert mem["alias_size_in_bytes"] == res["cache_bytes_per_device"] > 0
        assert mem["argument_size_in_bytes"] == (res["cache_bytes_per_device"]
                                                 + res["param_bytes_per_device"] + inputs)
        if kind == "prefill":
            assert mem["output_size_in_bytes"] - mem["alias_size_in_bytes"] == 8 * 128 * 4 / 8


def test_memory_sequence_parallelism_shrinks_the_saved_inputs(monkeypatch):
    """Four OLMo layers at S = 256 (vocab 512) under remat block.  When the
    backward starts, every layer's saved input (8, 256, 128) bf16 is alive
    (at least four at once), each a tensor of the stream, split over the
    batch axes and, under SP, over "model" too: a device holds half their
    bytes under SP.  Under remat
    none the peak is higher, with and without SP."""
    block = _one_layer_cell(monkeypatch, "train", remat="block", seq=256, n_layers=4,
                            vocab=512)
    count = dryrun.trace_cell(block)
    live = count["live"]
    kinds = dryrun._slot_kinds(block, live, 1)
    stream = {s for s, shape in enumerate(live.slot_shape)
              if shape == (8, 256, 128) and live.slot_bytes[s] == 8 * 256 * 128 * 2}
    held, most = 0, 0
    for s, n in zip(live.ev_slot, live.ev_bytes):
        if s in stream:
            held += 1 if n > 0 else -1
            most = max(most, held)
    assert most >= 4 and {kinds[s] for s in stream} == {"seq"}
    div = {ss: dryrun._divisors(block, POD_MESH, ss)["seq"] for ss in ("sp", "none")}
    assert div == {"sp": 8, "none": 4}
    sp = dryrun.cell_memory(block, count, POD_MESH, "sp")
    none = dryrun.cell_memory(block, count, POD_MESH, "none")
    assert sp["peak_bytes"] < none["peak_bytes"]
    remat_none = _one_layer_cell(monkeypatch, "train", remat="none", seq=256, n_layers=4,
                                 vocab=512)
    count_none = dryrun.trace_cell(remat_none)
    for ss, mem in (("sp", sp), ("none", none)):
        assert dryrun.cell_memory(remat_none, count_none, POD_MESH, ss)["peak_bytes"] > \
            mem["peak_bytes"]


def test_memory_microbatches_halve_the_activations(monkeypatch):
    """One OLMo layer at S = 256, remat block: two microbatches hold about
    half the stream and activations of one at their peaks (within 10%),
    beside a float32 gradient accumulator for every leaf."""
    cell = _one_layer_cell(monkeypatch, "train", remat="block", seq=256)
    one = dryrun.cell_memory(cell, dryrun.trace_cell(cell), POD_MESH, "none")
    two = dryrun.cell_memory(cell, dryrun.trace_cell(cell, 2), POD_MESH, "none", 2)

    def acts(mem):
        return mem["peak_parts"]["stream"] + mem["peak_parts"]["activations"]

    assert 0.45 <= acts(two) / acts(one) <= 0.55
    assert two["peak_parts"]["leaves"] > one["peak_parts"]["leaves"]


def test_traced_update_marks_the_gradients(monkeypatch):
    """The traced step's update is kept out of the log and marked: the
    gradients it is handed take their leaf's category, and the log stops
    growing while it runs."""
    cell = _one_layer_cell(monkeypatch, "train")
    live = dryrun.trace_cell(cell)["live"]
    leaf_slots = [s for s, c in enumerate(live.slot_cat) if isinstance(c, tuple)
                  and c[0] == "leaf"]
    assert len(leaf_slots) == len(tree_flatten(cell.params)[0])
    assert live.update_at is not None and 0 < live.update_at < len(live.ev_slot)


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
