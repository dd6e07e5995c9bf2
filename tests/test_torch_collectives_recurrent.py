"""The port's collective plan held against the JAX dry-run's records on the
recurrent families: RWKV6 (``rwkv6-3b``) and the RG-LRU hybrid
(``recurrentgemma-9b``), training and prefill under sequence parallelism.

The records are taken and read as ``_jax_collectives`` describes, each cell
from its probes alone (the full compile only proves memory); one cell is
also run through the JAX ``run_cell`` whole, to show that its probes give
the record's numbers.  The bounds are ``test_torch_collectives.py``'s: the
total within a factor of 1.5, each of all-gather, all-reduce and all-to-all
within 2 (a kind under 1% of both totals excepted), train FLOPs within 3%.
"""
import pytest

from _jax_collectives import (
    assert_memory_within,
    assert_within,
    jax_normalised,
    jax_records as run_jax,
    port_normalised,
    port_records as run_port,
)

JAX_TIMEOUT_S = 480

CELLS = {
    "rwkv-train": ("rwkv6-3b", "train_4k", "single", {}),
    "rwkv-prefill": ("rwkv6-3b", "prefill_32k", "single", {}),
    "hybrid-train": ("recurrentgemma-9b", "train_4k", "single", {}),
    "hybrid-prefill": ("recurrentgemma-9b", "prefill_32k", "single", {}),
}
FULL = {"rwkv-prefill-whole": CELLS["rwkv-prefill"]}     # through run_cell

_LOOKUP = ("The embedding's lookup runs for every batch row on the rank's table shard, and "
           "all-to-alls over 'model' and over 'data' move the rows to the stream's (batch, "
           "sequence) shard; a rank looks up the tokens of its own shard.")
# id: (cells, kind, axes, op_name tail, reason)
EXCEPTIONS = {
    "lookup-rows-model": (("hybrid-train", "hybrid-prefill"), "all-to-all", "model", "gather",
                          _LOOKUP),
    "lookup-rows-data": (("hybrid-train", "hybrid-prefill"), "all-to-all", "data", "gather",
                         _LOOKUP),
    "ring-cache-rows": (("hybrid-prefill",), "all-gather", "data", "scatter",
                        "The prefill's ring-cache write gathers every batch row's K and V "
                        "(f32[32,32768,1,256]) over 'data' before scattering them into a "
                        "cache whose batch is data-sharded; each rank writes its own rows."),
    "ring-cache-heads": (("hybrid-prefill",), "all-gather", "model", "scatter",
                         "K and V (f32[8,32768,1,256]), computed on the rank's sequence "
                         "shard, are gathered whole over 'model' before the ring's window is "
                         "scattered into its slots; the ranks need only the window's K and V "
                         "of their own slots (a collective-permute in the port's plan)."),
}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax({**CELLS, **FULL}, EXCEPTIONS,
                   tmp_path_factory.mktemp("jaxcoll") / "records.json", JAX_TIMEOUT_S,
                   probes_only=list(CELLS))


@pytest.fixture(scope="module")
def port_records():
    return run_port({**CELLS, **FULL})


def test_probes_alone_give_the_run_cell_record(jax_records):
    """A record's collectives and FLOPs come from its probes: the probes
    alone give ``run_cell``'s numbers."""
    probes, whole = jax_records["rwkv-prefill"], jax_records["rwkv-prefill-whole"]
    assert probes["flops_per_device"] == pytest.approx(whole["flops_per_device"], rel=1e-9)
    assert probes["total"] == pytest.approx(whole["total"], rel=1e-9)
    for key in ("kinds", "widened", "looped"):
        assert probes[key] == pytest.approx(whole[key], rel=1e-9), key
    assert whole["memory"]["temp_size_in_bytes"] and probes["memory"] == {}


def test_every_exception_takes_out_bytes(jax_records):
    """Each named exception matches HLO instructions in its cells."""
    for i, (cells, *_rest) in EXCEPTIONS.items():
        for cid in cells:
            assert jax_records[cid]["excepted"][i] > 0, (i, cid)


def test_the_scan_loop_counts_its_steps(jax_records):
    """RWKV6's WKV scan at prefill is a 32768-step loop; its per-step
    all-reduce of the outputs' partial sums over the state's key shards
    (f32[8,40,64] a step, 32 layers) is counted every step."""
    step = 8 * 40 * 64 * 4
    assert jax_records["rwkv-prefill"]["looped"]["all-reduce"] == pytest.approx(
        32 * (32768 - 1) * step)
    assert jax_records["hybrid-prefill"]["looped"]["all-reduce"] == 0


@pytest.mark.parametrize("cid", list(CELLS))
def test_plan_within_the_jax_record(jax_records, port_records, cid):
    assert_within(jax_normalised(jax_records[cid], cid, EXCEPTIONS),
                  port_normalised(port_records[cid]), cid)


@pytest.mark.parametrize("cid", ["rwkv-train", "hybrid-train"])
def test_train_flops_within_3_percent_of_jax(jax_records, port_records, cid):
    jax, port = jax_records[cid]["flops_per_device"], port_records[cid]["flops_per_device"]
    assert abs(port / jax - 1) <= 0.03, (cid, port / jax)


def test_memory_within_the_jax_record(jax_records, port_records):
    """The memory proof of the cell run whole: a device's argument, output
    and alias bytes from the port's trace against the record's
    ``memory_analysis()``."""
    assert_memory_within(jax_records["rwkv-prefill-whole"]["memory"],
                         port_records["rwkv-prefill-whole"]["memory"], "rwkv-prefill-whole")
