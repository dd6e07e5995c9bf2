"""The port's collective plan held against the JAX dry-run's records on the
Adafactor cells: DeepSeek-V3 (MLA and a mixture of experts) in training and
at decode, and Command R+ (dense GQA) in training.

The records are taken and read as ``_jax_collectives`` describes, each cell
from its probes alone.  The bounds are ``test_torch_collectives.py``'s: the
total within a factor of 1.5, each of all-gather, all-reduce and all-to-all
within 2 (a kind under 1% of both totals excepted), train FLOPs within 3%.
"""
import pytest

from _jax_collectives import (
    assert_within,
    jax_normalised,
    jax_records as run_jax,
    port_normalised,
    port_records as run_port,
)

JAX_TIMEOUT_S = 300

CELLS = {
    "deepseek-train": ("deepseek-v3-671b", "train_4k", "single", {}),
    "deepseek-decode": ("deepseek-v3-671b", "decode_32k", "single", {}),
    "command-r-train": ("command-r-plus-104b", "train_4k", "single", {}),
}

_LOOKUP = ("The tied embedding's lookup runs for all 256 batch rows on the rank's "
           "(vocab/model, d/data) table shard, and all-to-alls over 'model' and over 'data' "
           "move the rows to the stream's (batch, sequence) shard; a rank looks up the "
           "tokens of its own shard.")
# id: (cells, kind, axes, op_name tail, reason)
EXCEPTIONS = {
    "lookup-rows-model": (("command-r-train",), "all-to-all", "model", "gather", _LOOKUP),
    "lookup-rows-data": (("command-r-train",), "all-to-all", "data", "gather", _LOOKUP),
}


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax(CELLS, EXCEPTIONS, tmp_path_factory.mktemp("jaxcoll") / "records.json",
                   JAX_TIMEOUT_S, probes_only=list(CELLS))


@pytest.fixture(scope="module")
def port_records():
    return run_port(CELLS)


def test_every_exception_takes_out_bytes(jax_records):
    """Each named exception matches HLO instructions in its cells."""
    for i, (cells, *_rest) in EXCEPTIONS.items():
        for cid in cells:
            assert jax_records[cid]["excepted"][i] > 0, (i, cid)


def test_combined_gradient_reductions_are_widened(jax_records):
    """Command R+'s context-parallel gradients are all-reduced over "model"
    in reductions combined with the global norm's float32 sum, so their
    reducer is not ``clone_promoted``: read as widened, the record's
    all-reduces halve by more than its promoted ones alone would."""
    rec = jax_records["command-r-train"]
    assert rec["widened"]["all-reduce"] > 0.5 * rec["kinds"]["all-reduce"]


@pytest.mark.parametrize("cid", list(CELLS))
def test_plan_within_the_jax_record(jax_records, port_records, cid):
    assert_within(jax_normalised(jax_records[cid], cid, EXCEPTIONS),
                  port_normalised(port_records[cid]), cid)


@pytest.mark.parametrize("cid", ["deepseek-train", "command-r-train"])
def test_train_flops_within_3_percent_of_jax(jax_records, port_records, cid):
    jax, port = jax_records[cid]["flops_per_device"], port_records[cid]["flops_per_device"]
    assert abs(port / jax - 1) <= 0.03, (cid, port / jax)
