"""The port's serving path (``repro_torch``) held against the JAX package,
plus the port's own rules: it imports nothing of JAX or ``repro``, and it
never runs on the CPU unless told to."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.interference import fit_linear_interference as jax_fit
from repro.models import LM as JaxLM
from repro.models import reduced as jax_reduced
from repro.serve.engine import ServingEngine as JaxServingEngine

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.interference import fit_linear_interference
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.rwkv6_scan import rwkv6_scan
from repro_torch.launch.serve import serve_demo
from repro_torch.models import LM, params_from_jax, reduced
from repro_torch.models.layers import astype
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.scheduler import ServingFleet, serving_interference_model
from repro_torch.sim.runner import SimConfig, run_one

ROOT = Path(__file__).resolve().parent.parent


def _serve(engine, requests):
    """Admit requests as slots free up and step until all have finished."""
    pending = list(requests)
    done = {}
    while len(done) < len(requests):
        while pending and engine.free_slots():
            engine.add_request(*pending.pop(0))
        done.update(engine.step())
    return done


@pytest.fixture(scope="module")
def rwkv_pair():
    jcfg = jax_reduced(jax_get_config("rwkv6-3b"))
    jparams = JaxLM(jcfg).init(jax.random.PRNGKey(0))
    cfg = reduced(get_config("rwkv6-3b"))
    model = LM(cfg, device="cpu")
    return jcfg, jparams, model, params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _requests(vocab, lengths, n_new, seed):
    rng = np.random.default_rng(seed)
    return [(f"req{i}", rng.integers(0, vocab, n).tolist(), n_new)
            for i, n in enumerate(lengths)]


def test_engine_greedy_tokens_match_jax(rwkv_pair):
    jcfg, jparams, model, params = rwkv_pair
    reqs = _requests(jcfg.vocab, (16, 20, 64), 6, seed=11)
    jax_out = _serve(JaxServingEngine(JaxLM(jcfg), jparams, max_batch=3, max_seq=128), reqs)
    out = _serve(ServingEngine(model, params, max_batch=3, max_seq=128), reqs)
    assert out == jax_out
    assert all(len(toks) == 7 for toks in out.values())


def test_engine_slots_are_independent(rwkv_pair):
    """A request decoded beside others, in a reused slot, gives the tokens it
    gives alone."""
    _, _, model, params = rwkv_pair
    reqs = _requests(model.cfg.vocab, (16, 5, 33, 20), 5, seed=12)
    batched = _serve(ServingEngine(model, params, max_batch=2, max_seq=64), reqs)
    for req in reqs:
        alone = _serve(ServingEngine(model, params, max_batch=1, max_seq=64), [req])
        assert alone[req[0]] == batched[req[0]]


@pytest.mark.parametrize("k,lat", [
    ([1, 2, 4, 8], [1.1e-3, 1.3e-3, 1.8e-3, 2.6e-3]),
    ([1, 2, 3], [0.5, 0.5, 0.5]),
    ([1, 4, 9, 16], [3.0, 2.0, 7.0, 1.0]),
])
def test_fit_matches_jax(k, lat):
    assert fit_linear_interference(k, lat) == jax_fit(k, lat)


def test_fit_rejects_too_few_samples():
    with pytest.raises(ValueError):
        fit_linear_interference([1], [1.0])


def test_serve_demo_on_cpu():
    kernels = (flash_attention, flash_decode, rwkv6_scan)
    before = [kern.launches for kern in kernels]
    out = serve_demo(n_requests=10, max_batch=4, device="cpu")
    assert len(out["outputs"]) == 10
    assert list(out["fleet"]) == ["ibdash", "petrel", "lavea", "round_robin"]
    assert all(np.isfinite(lat) and 0.0 <= fail <= 1.0 for lat, fail in out["fleet"].values())
    assert all(0 <= t < 512 for toks in out["outputs"].values() for t in toks)
    m, c, r2 = out["interference"]
    assert np.isfinite([m, c, r2]).all()
    assert [kern.launches for kern in kernels] == before   # the CPU reaches no kernel


def test_import_isolation():
    """Every module of the port, and chip_smoke.py, import without JAX or
    anything of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 67


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("rwkv6-3b"))
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        LM(cfg, device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_demo(n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingFleet(serving_interference_model(), n_replicas=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_one("ibdash", SimConfig(scenario="stream"))
    assert ServingFleet(serving_interference_model(), n_replicas=4,
                        device="cpu").cluster.device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert LM(cfg, device="cpu").device == torch.device("cpu")


def test_unported_families_say_where_they_are_queued():
    """Every architecture of the registry, the JAX package's ten, builds an
    ``LM``.  Activation checkpointing (``remat``), a float8 cache and a KV
    cache in another float dtype (``kv_dtype="bfloat16"`` under a float32
    model), queued until they were ported, now compute the JAX function
    (``tests/test_torch_remat.py``, ``tests/test_torch_float8.py`` and
    ``tests/test_torch_kvdtype.py`` hold them against the JAX package): here
    the bfloat16 cache holds the float32 cache's keys and values rounded by
    ``astype``, and the logits stay within 1e-2 of the float32 cache's."""
    assert len(ARCHS) == 10
    for arch in ARCHS:
        cfg = reduced(get_config(arch))
        model = LM(cfg, device="cpu")
        assert [s.kind for s in model.segments]
    cfg = reduced(get_config("qwen1.5-0.5b"), n_layers=1)
    model = LM(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    batch = {"tokens": tokens, "labels": tokens}
    for remat in ("block", "dots"):
        assert torch.equal(LM(dataclasses.replace(cfg, remat=remat), device="cpu").loss(
            params, batch)[0], model.loss(params, batch)[0])
    kv16 = LM(dataclasses.replace(cfg, kv_dtype="bfloat16"), device="cpu")
    logits32, caches32 = model.prefill(params, {"tokens": tokens}, model.init_cache(1, 8))
    logits16, caches16 = kv16.prefill(params, {"tokens": tokens}, kv16.init_cache(1, 8))
    for key in ("k", "v"):
        assert caches16[0][key].dtype == torch.bfloat16
        assert torch.equal(caches16[0][key], astype(caches32[0][key], torch.bfloat16))
    torch.testing.assert_close(logits16, logits32, atol=1e-2, rtol=1e-2)
    kv8 = LM(dataclasses.replace(cfg, kv_dtype="float8_e4m3fn"), device="cpu")
    caches = kv8.init_cache(1, 8)
    logits, caches = kv8.prefill(params, {"tokens": tokens}, caches)
    assert caches[0]["k"].dtype == torch.float8_e4m3fn and bool(torch.isfinite(logits).all())
