"""Dispatch-level auditing of the port's registered kernels.

AST lint sees call syntax; it cannot see what a kernel *runs*.  This module
runs each registered kernel on tensors built from a size sweep, under a
``TorchDispatchMode`` that records every aten op with its inputs' and
outputs' dtypes, devices and sizes, and checks what it recorded against the
contracts the port relies on (the counterpart of the JAX package's jaxpr
audit, ``src/repro/analysis/kernel_audit.py``):

  * **float64 end to end**: the decision kernels in ``core/batched.py`` are
    float64 torch ops bit-identical to their numpy twins; a float32 constant
    or a low-precision promotion silently breaks that parity.  Any floating
    input or output of a recorded op that is not float64, in an ``f64``
    kernel, is flagged (once a dtype, with the ops that carry it).
  * **no host round trip**: ``aten._local_scalar_dense``/``aten.item`` (an
    ``.item()``, a ``float()`` of a tensor), a copy to the CPU of a tensor
    that was not on the CPU, and ops whose output size depends on the data
    (``nonzero``, ``masked_select``, ``unique``) wait for the card inside a
    hot kernel.  On the card the call also runs under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any
    synchronising CUDA call.
  * **bounded shapes**: ``decide_batch`` pads wave sizes to a bounded set of
    row counts (:func:`repro_torch.core.batched._padded`), so a sweep of wave
    sizes must give exactly ``expected_signatures`` distinct input
    signatures (shapes and dtypes of the tensors, values of the static
    arguments): what a CUDA-graph capture or a ``torch.compile`` would key
    on, the counterpart of the JAX audit's count of lowerings.
  * **in place**, the counterpart of donation: the serving engine writes its
    KV cache in place.  After the call each tensor of an ``inplace_argnums``
    argument must sit in the storage it sat in before, and no op may have
    produced a fresh tensor of such a tensor's dtype and size — that would
    mean the cache is double-buffered.

The audit runs from the ``kernel-hygiene`` lint rule's ``finalize``: the
registered port kernels come from :func:`builtin_targets`; test fixtures
self-describe by exporting a module-level ``TORCH_AUDIT_TARGETS`` list of
:class:`KernelSpec` (the rule spots the assignment in the AST and imports
the module by path).  :func:`run_audit` also returns what the call did (op
count, signatures, storage pointers), which ``chip_smoke.py`` prints when it
runs the targets on the card (``builtin_targets("cuda")``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "KernelSpec",
    "AuditResult",
    "audit_spec",
    "run_audit",
    "builtin_targets",
]


@dataclass
class KernelSpec:
    """One kernel to audit.

    ``fn`` is a thunk (imports stay lazy, so the linter pays for a model only
    when the rule runs); ``build(point, device)`` turns one sweep point (e.g.
    ``{"D": 6, "B": 100}``) into the positional arguments on ``device``:
    tensors (or dicts and lists of them) for traced arguments, plain Python
    values for scalars and for ``static_argnums`` positions.
    """

    name: str
    fn: Callable[[], Callable]
    build: Callable[[Dict[str, int], str], Tuple[Any, ...]]
    sweep: Tuple[Dict[str, int], ...]
    f64: bool = False
    static_argnums: Tuple[int, ...] = ()
    inplace_argnums: Tuple[int, ...] = ()
    expected_signatures: Optional[int] = None
    anchor: Optional[str] = None      # substring locating the finding's line
    device: str = "cpu"


@dataclass(frozen=True)
class _Tensor:
    """What the recorder keeps of one tensor an op took or gave."""

    dtype: torch.dtype
    device: str
    numel: int
    storage: int          # untyped storage's data pointer (0 on meta)


@dataclass(frozen=True)
class _Op:
    name: str
    inputs: Tuple[_Tensor, ...]
    outputs: Tuple[_Tensor, ...]


@dataclass
class AuditResult:
    """One spec's audit: its problems and what its calls did."""

    problems: List[str]
    ops: int = 0                                   # aten ops over the sweep
    signatures: int = 0                            # distinct input signatures
    # "argnum/path" -> (storage pointer before, after) of each in-place leaf,
    # at the sweep's first point
    pointers: Dict[str, Tuple[int, int]] = field(default_factory=dict)


def tensor_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` for every tensor in nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for key, val in tree.items():
            yield from tensor_leaves(val, f"{prefix}/{key}")
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            yield from tensor_leaves(val, f"{prefix}/{i}")


def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def _record(tree: Any) -> Tuple[_Tensor, ...]:
    return tuple(_Tensor(t.dtype, t.device.type, t.numel(), _storage(t))
                 for _, t in tensor_leaves(tree))


class _Recorder(TorchDispatchMode):
    """Every aten op run inside it, with its tensors' dtypes, devices, sizes
    and storages."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: List[_Op] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops.append(_Op(str(func), _record((args, kwargs or {})), _record(out)))
        return out


# ops that bring a value to the host, and ops whose output size depends on
# the data (the host must wait to learn it)
_SCALAR_OPS = ("aten._local_scalar_dense", "aten.item")
_DATA_SIZED_OPS = ("aten.nonzero", "aten.masked_select", "aten.unique", "aten._unique",
                   "aten.unique_dim", "aten.unique_consecutive")
_COPY_OPS = ("aten._to_copy", "aten.copy_", "aten._copy_from")


def _packet(name: str) -> str:
    """``aten.nonzero.default`` -> ``aten.nonzero``."""
    return name.rsplit(".", 1)[0] if name.count(".") >= 2 else name


def _scan_f64(ops: List[_Op], name: str) -> List[str]:
    """Floating values other than float64 inside a float64 kernel: one
    finding a dtype, naming the ops that carry it."""
    where: Dict[torch.dtype, List[str]] = {}
    for op in ops:
        for kind, tensors in (("input", op.inputs), ("output", op.outputs)):
            for t in tensors:
                if t.dtype.is_floating_point and t.dtype != torch.float64:
                    what = f"`{_packet(op.name)}` {kind}"
                    seen = where.setdefault(t.dtype, [])
                    if what not in seen:
                        seen.append(what)
    return [
        f"float64 kernel `{name}` carries {str(dtype)[6:]} values ({', '.join(whats)}) — "
        "the decision kernels are bit-identical float64 end to end; promote "
        "the constant/op to float64"
        for dtype, whats in where.items()
    ]


def _scan_host(ops: List[_Op], name: str) -> List[str]:
    hits: List[str] = []
    for op in ops:
        packet = _packet(op.name)
        if packet in _SCALAR_OPS or packet in _DATA_SIZED_OPS:
            what = packet
        elif packet in _COPY_OPS and any(t.device == "cpu" for t in op.outputs) \
                and any(t.device not in ("cpu", "meta") for t in op.inputs):
            what = f"{packet} to the CPU"
        else:
            continue
        if what not in hits:
            hits.append(what)
    return [
        f"kernel `{name}` runs `{what}`, a host round trip — the card waits "
        "for the host inside a hot kernel; keep the value on the device"
        for what in hits
    ]


def _check_inplace(spec: KernelSpec, args: Tuple[Any, ...], before: Dict[str, int],
                   ops: List[_Op]) -> Tuple[List[str], Dict[str, Tuple[int, int]]]:
    """Each in-place leaf in the storage it had before the call, and no op
    allocated a fresh buffer of one's dtype and size: an output in a
    storage that neither the arguments nor an earlier op's tensors had (a
    view of an argument, such as one layer of a stacked cache or weight,
    is none)."""
    problems: List[str] = []
    pointers: Dict[str, Tuple[int, int]] = {}
    leaves: Dict[str, torch.Tensor] = {}
    for argnum in spec.inplace_argnums:
        if argnum >= len(args):
            problems.append(
                f"kernel `{spec.name}` writes argnum {argnum} in place but only "
                f"{len(args)} arguments were specified")
            continue
        leaves.update(tensor_leaves(args[argnum], str(argnum)))
    for path, t in leaves.items():
        pointers[path] = (before.get(path, 0), _storage(t))
        if pointers[path][0] != pointers[path][1]:
            problems.append(
                f"kernel `{spec.name}` replaces its in-place buffer {path} "
                f"({str(t.dtype)[6:]}{list(t.shape)}) with a new one — the cache "
                "must be written where it lies")
    known = {_storage(t) for _, t in tensor_leaves(args)}
    fresh: List[Tuple[str, _Tensor]] = []
    for op in ops:
        for o in op.outputs:
            if o.storage not in known:
                known.add(o.storage)
                fresh.append((op.name, o))
    for path, t in leaves.items():
        copies = [name for name, o in fresh if o.dtype == t.dtype and o.numel == t.numel()]
        if copies:
            problems.append(
                f"kernel `{spec.name}` writes argnum {path.split('/')[0]} in place but "
                f"`{_packet(copies[0])}` allocates a fresh {str(t.dtype)[6:]}{list(t.shape)} "
                f"buffer the size of {path} — the buffer is double-allocated")
    return problems, pointers


@contextlib.contextmanager
def _sync_errors(device: str):
    """On the card, any synchronising CUDA call raises inside the block."""
    if not device.startswith("cuda"):
        yield
        return
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _signature(spec: KernelSpec, args: Tuple[Any, ...]) -> Tuple:
    sig = []
    for i, a in enumerate(args):
        if i in spec.static_argnums:
            sig.append(("static", repr(a)))
        else:
            sig.append(tuple((path, tuple(t.shape), t.dtype) for path, t in tensor_leaves(a)))
    return tuple(sig)


def run_audit(spec: KernelSpec) -> AuditResult:
    """Run every check on one kernel over its sweep."""
    try:
        fn = spec.fn()
    except Exception as e:  # the kernel itself failed to load
        return AuditResult([f"kernel `{spec.name}` could not be loaded: {e!r}"])

    result = AuditResult([])
    signatures: Dict[Tuple, Dict[str, int]] = {}
    seen = set()
    for i, point in enumerate(spec.sweep):
        args = spec.build(point, spec.device)
        before = {path: _storage(t) for n in spec.inplace_argnums if n < len(args)
                  for path, t in tensor_leaves(args[n], str(n))}
        recorder = _Recorder()
        try:
            with _sync_errors(spec.device), recorder:
                fn(*args)
        except Exception as e:
            result.problems.append(
                f"kernel `{spec.name}` failed at {point}: {type(e).__name__}: {e}")
            continue
        result.ops += len(recorder.ops)
        signatures.setdefault(_signature(spec, args), point)
        msgs = _scan_host(recorder.ops, spec.name)
        if spec.f64:
            msgs += _scan_f64(recorder.ops, spec.name)
        if i == 0 and spec.inplace_argnums:
            inplace, result.pointers = _check_inplace(spec, args, before, recorder.ops)
            msgs += inplace
        for m in msgs:
            if m not in seen:
                seen.add(m)
                result.problems.append(m)
    result.signatures = len(signatures)
    if spec.expected_signatures is not None and signatures \
            and len(signatures) != spec.expected_signatures:
        pts = ", ".join(str(p) for p in signatures.values())
        result.problems.append(
            f"kernel `{spec.name}` takes {len(signatures)} distinct input signatures across "
            f"the size sweep (expected {spec.expected_signatures}; one per padded bucket) — "
            "wave sizes give the kernel new shapes; pad the row count (`_padded`) or fix "
            f"static_argnums [distinct at: {pts}]")
    return result


def audit_spec(spec: KernelSpec) -> List[str]:
    """Run every check on one kernel; returns human-readable problems."""
    return run_audit(spec).problems


# -- the registered port kernels ---------------------------------------------------

_IBDASH_GAMMA = 3          # replication budget used for the audit's inputs
_ALPHA, _BETA = 0.5, 0.25
_TIER_BUDGET, _N_TIERS = 2.5, 3


def _batched_kernel(name: str) -> Callable[[], Callable]:
    def thunk():
        from repro_torch.core import batched

        return getattr(batched, name)

    return thunk


def _padded(B: int) -> int:
    from repro_torch.core import batched

    return batched._padded(B)


# Fleet-size sweep, the JAX audit's: wave sizes B spanning three padded
# buckets (8 -> 8, 100 -> 128, 900/1000 -> 1024) at two fleet sizes D.  The
# ibdash scan's shapes depend only on n_scan = min(gamma+1, D-1), which
# saturates for D >= gamma+2 — the audit *proves* fleet growth adds no
# shape.
_FLEET_SWEEP = (
    {"D": 6, "B": 8},
    {"D": 6, "B": 100},
    {"D": 24, "B": 900},
    {"D": 24, "B": 1000},
)


def _gen(device: str) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _f64(gen, device, *shape):
    return torch.rand(shape, generator=gen, dtype=torch.float64, device=device) * 10.0


def _bools(gen, device, *shape):
    return torch.rand(shape, generator=gen, device=device) < 0.7


def _select_queue_args(p, device):
    gen = _gen(device)
    B, n_scan = _padded(p["B"]), min(_IBDASH_GAMMA + 1, p["D"] - 1)
    masked = torch.where(_bools(gen, device, B, p["D"]), _f64(gen, device, B, p["D"]),
                         torch.inf)
    return (masked, n_scan + 1)


def _ibdash_args(p, device):
    gen = _gen(device)
    B, n_scan = _padded(p["B"]), min(_IBDASH_GAMMA + 1, p["D"] - 1)
    return (
        _f64(gen, device, B, n_scan + 1),                      # s_total
        torch.rand((B, n_scan + 1), generator=gen, dtype=torch.float64, device=device),
        torch.randint(0, p["D"] + 1, (B,), generator=gen, device=device),   # n_feas
        _ALPHA, _BETA, _IBDASH_GAMMA,
    )


def _lavea_args(p, device):
    gen = _gen(device)
    B = _padded(p["B"])
    return (_f64(gen, device, B, p["D"]), _bools(gen, device, B, p["D"]))


def _round_robin_args(p, device):
    gen = _gen(device)
    B = _padded(p["B"])
    return (_bools(gen, device, B, p["D"]),
            torch.randint(0, p["D"], (B,), generator=gen, device=device))


def _tier_args(p, device):
    gen = _gen(device)
    B = _padded(p["B"])
    return (_f64(gen, device, B, p["D"]), _bools(gen, device, B, p["D"]),
            torch.randint(0, _N_TIERS, (p["D"],), generator=gen, device=device),
            _TIER_BUDGET, _N_TIERS)


def _decision_specs(device: str) -> List[KernelSpec]:
    def spec(name, build, static=()):
        return KernelSpec(name=name, fn=_batched_kernel(name), build=build, sweep=_FLEET_SWEEP,
                          f64=True, static_argnums=static, expected_signatures=3,
                          anchor=f"def {name}", device=device)

    return [
        spec("select_queue", _select_queue_args, static=(1,)),
        spec("ibdash_scan_kernel", _ibdash_args, static=(5,)),
        spec("lavea_kernel", _lavea_args),
        spec("round_robin_kernel", _round_robin_args),
        spec("tier_escalation_kernel", _tier_args, static=(4,)),
    ]


def _ops_kernel(opname: str, **fixed) -> Callable[[], Callable]:
    def thunk():
        from repro_torch.kernels import ops

        op = getattr(ops, opname)

        def wrapped(*tensors):
            return op(*tensors, **fixed)

        return wrapped

    return thunk


def _f32(gen, device, *shape):
    if device == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return torch.randn(shape, generator=gen, device=device)


def _attention_args(p, device):
    gen = None if device == "meta" else _gen(device)
    return tuple(_f32(gen, device, 1, p["S"], 2, 32) for _ in range(3))


def _decode_args(p, device):
    gen = None if device == "meta" else _gen(device)
    return (_f32(gen, device, 1, 2, 32), _f32(gen, device, 1, p["S"], 2, 32),
            _f32(gen, device, 1, p["S"], 2, 32),
            torch.full((1,), p["S"], dtype=torch.int32, device=device))


def _rwkv6_args(p, device):
    gen = None if device == "meta" else _gen(device)
    r, k, v = (_f32(gen, device, 1, p["T"], 2, 32) for _ in range(3))
    w = _f32(gen, device, 1, p["T"], 2, 32)
    if device != "meta":
        w = torch.sigmoid(w)          # a decay in (0, 1)
    return (r, k, v, w, _f32(gen, device, 2, 32), _f32(gen, device, 1, 2, 32, 32))


def _ops_specs(device: str) -> List[KernelSpec]:
    """The kernels' public entry points, on the card (the CUDA kernels
    launch) or, on the CPU, on the meta device (their meta route: the
    wrappers' shapes and allocations, no plain version)."""
    dev = "meta" if device == "cpu" else device

    def spec(name, fn, build, sweep):
        return KernelSpec(name=name, fn=fn, build=build, sweep=sweep, expected_signatures=2,
                          anchor=f"def {name}", device=dev)

    return [
        spec("attention", _ops_kernel("attention", causal=True), _attention_args,
             ({"S": 16}, {"S": 32})),
        spec("decode_attention", _ops_kernel("decode_attention"), _decode_args,
             ({"S": 16}, {"S": 32})),
        spec("rwkv6", _ops_kernel("rwkv6"), _rwkv6_args, ({"T": 8}, {"T": 16})),
    ]


_ENGINE_B, _ENGINE_S, _ENGINE_PROMPT = 2, 32, 8


def _engine_specs(device: str) -> List[KernelSpec]:
    """``LM.decode_step`` and ``LM.prefill`` of a reduced ``qwen1.5-0.5b``
    (2 layers, vocab 128; the JAX audit's ``_engine_ctx``) through the
    caches of a ``ServingEngine`` (B=2, S=32), written in place.  The model,
    its weights from a seed and the engine are built once, at the first
    target that needs them."""
    ctx: Dict[str, Any] = {}

    def context() -> Dict[str, Any]:
        if not ctx:
            from repro_torch.configs import get_config
            from repro_torch.models import LM, reduced
            from repro_torch.serve.engine import ServingEngine

            cfg = reduced(get_config("qwen1.5-0.5b"), n_layers=2, vocab=128)
            model = LM(cfg, device=device)
            params = model.init(_gen(device))
            ctx.update(model=model, params=params, vocab=cfg.vocab,
                       engine=ServingEngine(model, params, max_batch=_ENGINE_B,
                                            max_seq=_ENGINE_S))
        return ctx

    def fn(name: str) -> Callable[[], Callable]:
        return lambda: torch.inference_mode()(getattr(context()["model"], name))

    def tokens(n: int) -> torch.Tensor:
        return torch.randint(0, context()["vocab"], (_ENGINE_B, n), generator=_gen(device),
                             device=device)

    def decode_args(p, dev):
        """A decode step at position 8 over the engine's caches, after a
        prefill of 8 tokens into them (as the engine's slots hold a prompt)."""
        c = context()
        caches = c["engine"].caches
        with torch.inference_mode():
            c["model"].prefill(c["params"], {"tokens": tokens(_ENGINE_PROMPT)}, caches)
        pos = torch.full((_ENGINE_B,), _ENGINE_PROMPT, dtype=torch.int32, device=dev)
        return (c["params"], tokens(1)[:, 0], pos, caches)

    def prefill_args(p, dev):
        c = context()
        return (c["params"], {"tokens": tokens(_ENGINE_PROMPT)}, c["engine"].caches)

    return [
        KernelSpec(name="engine.decode_step", fn=fn("decode_step"), build=decode_args,
                   sweep=({},), inplace_argnums=(3,), expected_signatures=1,
                   anchor="self.model.decode_step(", device=device),
        KernelSpec(name="engine.prefill", fn=fn("prefill"), build=prefill_args,
                   sweep=({},), inplace_argnums=(2,), expected_signatures=1,
                   anchor="self.model.prefill(", device=device),
    ]


def builtin_targets(device: str = "cpu") -> Dict[str, List[KernelSpec]]:
    """Registered kernels keyed by the repo-relative file that defines
    them; the rule audits an entry when its file is in the scanned set.
    ``device="cuda"`` rebuilds every target on the card."""
    return {
        "src/repro_torch/core/batched.py": _decision_specs(device),
        "src/repro_torch/kernels/ops.py": _ops_specs(device),
        "src/repro_torch/serve/engine.py": _engine_specs(device),
    }
