"""A run loads nothing of JAX or of the JAX package: checked in a fresh
process by the top-level name of every loaded module, compared whole."""
import subprocess
import sys

from port_bench.harness import ROOT

CODE = """
import sys, time, torch
sys.path.insert(0, '.')
from port_bench.tests.tiny import run
from port_bench.harness import jax_modules
for cell in ('minitron-8b.rag', 'qwen1.5-0.5b.train'):
    run(cell, seconds=0.5, trace=True)
print('LOADED', jax_modules())
"""


def test_a_run_loads_no_jax():
    proc = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout


def test_the_check_compares_whole_names():
    from port_bench.harness import jax_modules

    sys.modules["repro_torch_lookalike"] = sys
    try:
        assert "repro_torch_lookalike" not in jax_modules()
    finally:
        del sys.modules["repro_torch_lookalike"]
