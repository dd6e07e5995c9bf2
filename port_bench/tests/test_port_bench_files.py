"""Every file the benchmark finds by name is there, and BENCHMARK.json has
the keys, names, units and bounds the harness and its checkers expect."""
import ast
import json
import re

import pytest

from port_bench.harness import HERE, ROOT, load_cell, metric_names, reader

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["paths"] == ["port_bench"] and (ROOT / "port_bench").is_dir()
    assert BENCH["command"][:3] == ["python3", "-m", "port_bench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_found_by_name(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and entry["file"].startswith("port_bench/configs/")
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["reduced"] == entry["reduced"]
    assert (HERE / "reference" / f"{conf['family']}.py").is_file()
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_found_by_name(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and entry["chips"] in (1, 4) and len(entry["why"]) <= 200
    cell = load_cell(BENCH, entry["name"])
    assert (HERE / "drivers" / f"{cell.mix['driver']}.py").is_file()
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metrics_found_by_name(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert callable(reader(metric["name"]))
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        moves = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        for cell in metric["workloads"]:
            assert moves in metric_names(BENCH, cell, "end_to_end")


def test_no_source_imports_jax_or_the_jax_package():
    """By the top-level name of every import in the benchmark's sources,
    compared whole (the port is ``repro_torch``)."""
    found = []
    for path in HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) and node.level == 0
                     and node.module else [])
            found += [(path.name, n) for n in names
                      if n.split(".")[0] in ("jax", "jaxlib", "flax", "repro")]
    assert not found


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
        mods |= {n.module.split(".")[0] for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module and n.level == 0}
        assert mods <= {"torch", "numpy", "typing", "__future__", "math"}, (path, mods)
