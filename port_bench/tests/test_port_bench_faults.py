"""The check fails what it must: each fault a cell can have, planted in the
program underneath a whole run at a tiny size, and the control (the
reference in float8 in the program's place) on three seeds."""
import pytest

from port_bench import faults

from .tiny import SHRINK, run

@pytest.mark.parametrize("kind", faults.SERVE)
def test_serving_fault_reads_incorrect(kind):
    with faults.serve_fault(kind):
        out = run("minitron-8b.rag")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("kind", faults.TRAIN)
def test_training_fault_reads_incorrect(kind):
    with faults.train_fault(kind):
        out = run("qwen1.5-0.5b.train")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_serving_control_reads_incorrect(seed):
    from port_bench import serving
    from port_bench.harness import Record, driver, load_cell, reference

    from .tiny import CPU, bench

    cell = load_cell(bench(), "minitron-8b.rag", SHRINK["minitron-8b.rag"])
    rec = Record(cell, 1.0)
    driver("serve_open").run(rec, seed, CPU, False, 0.0, lambda _: None)
    got = serving.readings(rec, reference("dense"), CPU, ("fp8",))
    limit = cell.limits["max_logit_gap"]
    assert got["program"].max() <= limit < got["fp8"].max()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_training_control_reads_incorrect(seed):
    from port_bench.drivers import train
    from port_bench.harness import Record, load_cell, reference

    from .tiny import CPU, bench

    cell = load_cell(bench(), "qwen1.5-0.5b.train", SHRINK["qwen1.5-0.5b.train"])
    rec = Record(cell, 0.5)
    train.run(rec, seed, CPU, False, 0.0, lambda _: None)
    ctl = train.readings(rec, reference("dense"), CPU, "fp8")
    assert any(v > cell.limits[k] for k, v in ctl.items()), ctl
