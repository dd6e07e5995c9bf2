"""The port's linter (``repro_torch.analysis``) on the CPU.

Covers: the port's linter against the JAX linter (``repro.analysis``) on
the golden fixtures under ``tests/fixtures/lint/`` (read, never written),
rule by rule; torch fixtures written into ``tmp_path`` from strings (a file
under ``tests/`` would be scanned by both linters' self-clean runs), each
fault firing exactly its finding and each clean twin silent; the torch base
effects of the call graph; the dispatch-level audit of the port's real
kernels (the ops on the meta device); and the self-clean gate, run in a
subprocess that must import nothing of JAX and nothing of the JAX package.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

import repro.analysis as jax_lint
import repro_torch.analysis as torch_lint
from repro_torch.analysis.callgraph import summarize_module
from repro_torch.analysis.kernel_audit import builtin_targets, run_audit

from test_analysis import ALL_RULES, FIXTURE_OPTIONS, FIXTURE_STEMS, FIXTURES, REPO

# Rules whose twin reads another live source or finds kernels another way,
# so the two linters may differ on the fixtures:
PARITY_EXCEPTIONS = {
    # the JAX rule traces AUDIT_TARGETS with jax.make_jaxpr; the twin runs
    # TORCH_AUDIT_TARGETS under a dispatch recorder and never imports the
    # JAX fixtures
    "kernel-hygiene": "audits TORCH_AUDIT_TARGETS, not the JAX fixtures' AUDIT_TARGETS",
    # the JAX rule finds kernels by jax.jit; the twin by DECISION_KERNELS and
    # .launches counters, with torch.Tensor-annotated parameters traced, so
    # the jax.jit fixtures hold no kernel for it
    "jit-hygiene": "finds kernels by DECISION_KERNELS/.launches, not by jax.jit",
}
PARITY_RULES = [r for r in ALL_RULES if r not in PARITY_EXCEPTIONS]


def run_rule(lint, rule, path, options=None, root=REPO):
    """Run ONE rule of ``lint`` over a file or directory, everywhere-scoped."""
    cfg = lint.LintConfig(
        exclude=(), select=(rule,),
        rules={rule: lint.RuleSettings(paths=("",), options=options or {})},
    )
    return lint.Analyzer(cfg, root=str(root)).run([str(path)])


def keys(report):
    return sorted((f.path, f.line, f.rule) for f in report.findings)


# -- the JAX linter's fixtures -------------------------------------------------------
FIXTURE_ITEMS = sorted(p for p in FIXTURES.iterdir()
                       if p.suffix == ".py" or p.name.startswith("transitive_"))


@pytest.mark.parametrize("rule", PARITY_RULES)
def test_fixture_findings_match_the_jax_linter(rule):
    """Each fixture file and each ``transitive_*`` package, one run of the
    rule apiece: the same ``(path, line, rule)`` findings from both linters,
    and some on the rule's own violating fixture."""
    opts = FIXTURE_OPTIONS.get(rule)
    for item in FIXTURE_ITEMS:
        want = keys(run_rule(jax_lint, rule, item, opts))
        assert keys(run_rule(torch_lint, rule, item, opts)) == want, item.name
        if item.name == f"{FIXTURE_STEMS[rule]}_violation.py":
            assert any(r == rule for _, _, r in want)


def test_parity_exceptions_are_the_twins_with_other_sources():
    """The named exceptions: the JAX jit fixture holds kernels only for the
    JAX rule, and the port's rules are the JAX rules by name."""
    assert set(torch_lint.available_rules()) == set(jax_lint.available_rules())
    assert set(PARITY_EXCEPTIONS) < set(ALL_RULES)
    jit = FIXTURES / "jit_violation.py"
    assert keys(run_rule(jax_lint, "jit-hygiene", jit)) != []
    assert keys(run_rule(torch_lint, "jit-hygiene", jit)) == []


# -- torch fixtures ----------------------------------------------------------------
RNG_VIOLATION = '''
import torch


def draw(n):
    return torch.randn(n)
'''
RNG_CLEAN = '''
import torch


def draw(n, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=gen)
'''
RNG_TRANSITIVE = '''
import torch


def _jitter(n):
    return torch.rand(n)


class Policy:
    def decide(self, ctx):
        return _jitter(3)
'''
JIT_VIOLATION = '''
import torch


def bad_kernel(scores: torch.Tensor, k: int) -> torch.Tensor:
    best = scores.min(dim=1).values
    host = best.cpu()
    if best.sum() > 0:
        return host
    return scores[:, :k]


def counted_kernel(x: torch.Tensor, alpha: float) -> torch.Tensor:
    counted_kernel.launches += 1
    if alpha > 0:
        return x * float(x.sum())
    return x


DECISION_KERNELS = (bad_kernel,)
'''
JIT_CLEAN = '''
import torch


def good_kernel(scores: torch.Tensor, k: int) -> torch.Tensor:
    best = scores.min(dim=1).values
    if k > 1:
        best = best * 2.0
    return torch.where(best > 0, best, -best)


def counted_kernel(x: torch.Tensor, alpha: float) -> torch.Tensor:
    counted_kernel.launches += 1
    if alpha > 0:
        return x * alpha
    return x


DECISION_KERNELS = (good_kernel,)
'''
KERNEL_VIOLATION = '''
import torch

from repro_torch.analysis.kernel_audit import KernelSpec


def leaky_kernel(x):
    # float32 weights inside a kernel that must be float64 end to end
    w = torch.tensor([0.5, 2.0, 1.0, 1.0], dtype=torch.float32)
    return (x * w).sum(dim=1)


def syncing_kernel(x):
    return x.sum().item()


def unpadded_kernel(x):
    return x * 2.0


def hoarder_kernel(x, cache):
    # cache is written in place below, but this builds a new one
    return x.sum(), cache + 1.0


def _f64(*shape):
    return torch.ones(shape, dtype=torch.float64)


TORCH_AUDIT_TARGETS = [
    KernelSpec(name="leaky_kernel", fn=lambda: leaky_kernel,
               build=lambda p, d: (_f64(p["B"], 4),), sweep=({"B": 8},), f64=True,
               anchor="def leaky_kernel"),
    KernelSpec(name="syncing_kernel", fn=lambda: syncing_kernel,
               build=lambda p, d: (_f64(4),), sweep=({},), f64=True,
               anchor="def syncing_kernel"),
    KernelSpec(name="unpadded_kernel", fn=lambda: unpadded_kernel,
               # raw wave sizes straight into the shape: every wave is a new shape
               build=lambda p, d: (_f64(p["B"], 4),), sweep=({"B": 8}, {"B": 9}, {"B": 10}),
               f64=True, expected_signatures=1, anchor="def unpadded_kernel"),
    KernelSpec(name="hoarder_kernel", fn=lambda: hoarder_kernel,
               build=lambda p, d: (_f64(4, 4), _f64(3, 5)), sweep=({},),
               inplace_argnums=(1,), anchor="def hoarder_kernel"),
]
'''
KERNEL_CLEAN = '''
import torch

from repro_torch.analysis.kernel_audit import KernelSpec


def tidy_kernel(x, cache):
    w = torch.tensor([0.5, 2.0, 1.0, 1.0], dtype=torch.float64)
    cache.add_(1.0)
    return (x * w).sum(dim=1), cache


def _bucket(B):
    return 1 << max(B - 1, 0).bit_length()


TORCH_AUDIT_TARGETS = [
    KernelSpec(name="tidy_kernel", fn=lambda: tidy_kernel,
               build=lambda p, d: (torch.ones((_bucket(p["B"]), 4), dtype=torch.float64),
                                   torch.zeros(3, 5, dtype=torch.float64)),
               sweep=({"B": 70}, {"B": 100}), f64=True, inplace_argnums=(1,),
               expected_signatures=1, anchor="def tidy_kernel"),
]
'''


def write(tmp_path, name, source):
    path = tmp_path / name
    path.write_text(textwrap.dedent(source).lstrip())
    return path


def line_of(path, text):
    return next(i for i, line in enumerate(path.read_text().splitlines(), 1) if text in line)


@pytest.mark.parametrize("source,want", [
    (RNG_VIOLATION, [("torch.randn(n)", "global torch draw `torch.randn()`")]),
    (RNG_CLEAN, []),
    (RNG_TRANSITIVE, [("torch.rand(n)", "global torch draw `torch.rand()`"),
                      ("return _jitter(3)", "decide -> _jitter -> torch.rand()")]),
], ids=["violation", "clean", "transitive"])
def test_rng_discipline_flags_torch_draws(tmp_path, source, want):
    path = write(tmp_path, "mod.py", source)
    report = run_rule(torch_lint, "rng-discipline", path, {"time_call_paths": ("",)},
                      root=tmp_path)
    got = [(f.line, f.message) for f in report.findings]
    assert [line for line, _ in got] == [line_of(path, text) for text, _ in want]
    for (_, msg), (_, expect) in zip(got, want):
        assert expect in msg


def test_jit_hygiene_flags_host_syncs_and_branches_in_decision_kernels(tmp_path):
    """One finding a fault: the ``.cpu()`` and the branch on a tensor in a
    ``DECISION_KERNELS`` function, the ``float()`` of a tensor in a kernel
    that counts its launches; the branch on the static ``alpha`` is
    allowed, and the clean twin is silent."""
    path = write(tmp_path, "kernels.py", JIT_VIOLATION)
    report = run_rule(torch_lint, "jit-hygiene", path, root=tmp_path)
    got = [(f.line, f.message.split(" ", 1)[0]) for f in report.findings]
    assert got == [(line_of(path, "best.cpu()"), "`.cpu()`"),
                   (line_of(path, "if best.sum() > 0"), "Python"),
                   (line_of(path, "float(x.sum())"), "`float()`")]
    clean = write(tmp_path, "clean.py", JIT_CLEAN)
    assert run_rule(torch_lint, "jit-hygiene", clean, root=tmp_path).findings == []


KERNEL_FAULTS = {
    "leaky_kernel": "carries float32 values",
    "syncing_kernel": "aten._local_scalar_dense",
    "unpadded_kernel": "3 distinct input signatures",
    "hoarder_kernel": "double-allocated",
}


def test_kernel_hygiene_fires_each_fault_once(tmp_path):
    path = write(tmp_path, "kernel_targets.py", KERNEL_VIOLATION)
    report = run_rule(torch_lint, "kernel-hygiene", path, root=tmp_path)
    got = sorted((f.line, f.message) for f in report.findings)
    assert len(got) == len(KERNEL_FAULTS)
    for (line, msg), (name, fault) in zip(got, KERNEL_FAULTS.items()):
        assert line == line_of(path, f"def {name}") and f"`{name}`" in msg and fault in msg
    clean = write(tmp_path, "kernel_clean.py", KERNEL_CLEAN)
    assert run_rule(torch_lint, "kernel-hygiene", clean, root=tmp_path).findings == []
    # the JAX linter imports AUDIT_TARGETS modules only: it never runs these
    assert run_rule(jax_lint, "kernel-hygiene", path, root=tmp_path).findings == []


# -- the torch base effects of the call graph -----------------------------------------------
@pytest.mark.parametrize("call,kind", [
    ("torch.randn(3)", "global-rng"), ("torch.rand_like(x)", "global-rng"),
    ("torch.randint(0, 5, (2,))", "global-rng"), ("torch.multinomial(x, 2)", "global-rng"),
    ("torch.manual_seed(0)", "global-rng"), ("torch.cuda.manual_seed_all(0)", "global-rng"),
    ("x.item()", "host-sync"), ("x.tolist()", "host-sync"), ("x.cpu()", "host-sync"),
    ("x.numpy()", "host-sync"), ('x.to("cpu")', "host-sync"),
    ("torch.cuda.synchronize()", "host-sync"),
    ("torch.randn(3, generator=g)", None), ('x.to("cuda")', None), ("x.sum()", None),
])
def test_torch_calls_have_their_base_effects(call, kind):
    src = f"def f(x, g):\n    return {call}\n"
    summary = summarize_module("mod.py", src)
    effects = [e.kind for e in summary.functions["mod.f"].effects]
    assert effects == ([kind] if kind else [])


# -- the real targets ----------------------------------------------------------------
TARGETS = {spec.name: (path, spec) for path, specs in builtin_targets().items()
           for spec in specs}


@pytest.mark.parametrize("name", sorted(TARGETS))
def test_builtin_targets_audit_clean_on_the_cpu(name):
    """Each registered kernel: no finding, its expected count of input
    signatures over the sweep, and (the engine's) caches in the storage
    they had."""
    path, spec = TARGETS[name]
    result = run_audit(spec)
    assert result.problems == []
    assert result.ops > 0 and result.signatures == spec.expected_signatures
    assert (REPO / path).read_text().count(spec.anchor) >= 1
    if spec.inplace_argnums:
        assert result.pointers and all(a == b for a, b in result.pointers.values())
    if name in ("attention", "decode_attention", "rwkv6"):
        assert spec.device == "meta"


def test_builtin_targets_cover_the_decision_ops_and_engine_kernels():
    assert set(TARGETS) == {
        "select_queue", "ibdash_scan_kernel", "lavea_kernel", "round_robin_kernel",
        "tier_escalation_kernel", "attention", "decode_attention", "rwkv6",
        "engine.decode_step", "engine.prefill",
    }
    assert all(spec.f64 == (path.endswith("batched.py")) for path, spec in TARGETS.values())


# -- the self-clean gate, in a process of its own ------------------------------------------
_CLI = """
import json, sys
from repro_torch.analysis.__main__ import main
rc = main(sys.argv[1:])
print(json.dumps({"rc": rc, "modules": sorted(
    m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))}))
"""


@pytest.fixture(scope="module")
def self_clean(tmp_path_factory):
    out = tmp_path_factory.mktemp("lint") / "report.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", _CLI, "src", "tests", "benchmarks", "examples",
         "--json", str(out)],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[-1]), json.loads(out.read_text())


def test_repo_is_self_clean(self_clean):
    """``python -m repro_torch.analysis src tests benchmarks examples``
    exits 0 with no error, every rule having run."""
    result, report = self_clean
    assert result["rc"] == 0 and report["errors"] == 0
    assert report["files_scanned"] > 100
    assert set(ALL_RULES) <= set(report["rules_run"])


def test_linter_imports_nothing_of_jax(self_clean):
    result, _ = self_clean
    assert result["modules"] == []
