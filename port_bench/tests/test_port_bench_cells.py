"""Each cell end to end at a tiny size on the CPU: a result line of the
shape the README gives, its numbers compared beside their limits, ``checks``
last; and the CLI that refuses to run without a card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.harness import ROOT, load_cell, metric_names

from .tiny import SHRINK, bench, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", sorted(SHRINK))
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_cell_end_to_end(cell, trace):
    out = run(cell, trace=trace)
    line = json.loads(json.dumps(out))
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(v["value"] <= v["limit"] for v in line["checks"].values())
    assert line["device"]["platform"] == "cpu" and line["device"]["count"] == 1
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in metric_names(bench(), cell, kind)}
    assert set(line["metrics"]) <= want
    if not trace:     # every end-to-end metric reads on the CPU too (no device number)
        assert set(line["metrics"]) == want
    for m in line["metrics"].values():
        assert m["value"] == m["value"] and m["value"] >= 0


def test_setup_counts_from_the_process_start():
    out = run("minitron-8b.rag")
    assert 0 < out["metrics"]["setup_s"]["value"] < 60


def test_same_seed_same_inputs_and_every_seed_the_same_work():
    from port_bench.traffic import open_loop

    mix = load_cell(bench(), "minitron-8b.rag").mix
    a, b = open_loop(mix, 51, 2 ** 31 + 11, 256000), open_loop(mix, 51, 2 ** 31 + 11, 256000)
    c = open_loop(mix, 51, 5, 256000)
    assert [r.due for r in a] == [r.due for r in b]
    assert all((x.prompt == y.prompt).all() for x, y in zip(a, b))
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in c)
    assert sorted(r.n_out for r in a) == sorted(r.n_out for r in c)
    assert max(r.due for r in a) < 51 and len(a) == round(mix["rate_per_s"] * 51)


def test_cli_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                           "minitron-8b.rag", "--seed", "3", "--seconds", "1"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "{" not in proc.stdout


def test_fails_where_only_the_benchmark_is(tmp_path):
    """A directory with only BENCHMARK.json and port_bench/: the program is
    not there, so no run can import it."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("from port_bench.harness import use_program; use_program(); "
            "import repro_torch.serve.engine")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "ModuleNotFoundError" in proc.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_cell_on_the_card(card, cell):
    proc = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload", cell,
                           "--seed", "12345", "--seconds", "5", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
