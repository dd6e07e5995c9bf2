"""The port's collective plan (``repro_torch.launch.dryrun.plan_collectives``)
held against the JAX dry-run's own records on dense, MoE and GQA cells.

The records are taken, and read for what an H100 program would send, as
``_jax_collectives`` describes: a subprocess runs the JAX ``run_cell`` on
Auto-axes meshes of data 4 x model 2 and pod 2 x data 2 x model 2; widened
bytes are halved, loop steps counted, the ``EXCEPTIONS`` below taken out;
the port's ``run_cell`` runs on an ``AbstractMesh`` of the same sizes, its
reduce-scatters counted as the all-reduces of their inputs.

Within those rules, a compared cell's total lies within a factor of 1.5 of
the record's and each of all-gather, all-reduce and all-to-all within a
factor of 2, a kind under 1% of both totals excepted; the sequence-parallel
cell moves more bytes over "model" than the one without, in both packages,
counted so.
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

JAX_TIMEOUT_S = 240

# id: (arch, shape, mesh kind, variant).  The int8 cell is left out: its
# compile aborts XLA (``Check failed`` at spmd_partitioner_util.cc:495).
CELLS = {
    "olmo-train-sp": ("olmo-1b", "train_4k", "single", {}),
    "olmo-train-none": ("olmo-1b", "train_4k", "single", {"seq_shard": "none"}),
    "olmo-prefill": ("olmo-1b", "prefill_32k", "single", {}),
    "olmo-decode": ("olmo-1b", "decode_32k", "multi", {}),
    "moe-train-sp": ("qwen2-moe-a2.7b", "train_4k", "single", {}),
    "minitron-train-sp": ("minitron-8b", "train_4k", "single", {}),
}

_SCORES = ("Under SP XLA shards attention's sequence and materialises the (B, H, S, S) "
           "f32 weights; the backward redistributes them from query- to key-sharded. "
           "The port's attention kernel never materialises them: it gathers the "
           "sequence before attention (Megatron SP).")
_LOOKUP = ("The untied embedding's lookup runs for all 256 batch rows on the rank's "
           "(vocab/model, d/data) table shard (f32[256,4096,1024]), is all-reduced over "
           "'model', and all-to-alls over 'model' and over 'data' then move the rows to the "
           "stream's (batch, sequence) shard; a rank looks up the tokens of its own shard.")
# id: (cells, kind, axes, op_name tail, reason)
EXCEPTIONS = {
    "attention-scores": (("olmo-train-sp", "moe-train-sp"), "all-to-all",
                         "model", "mul", _SCORES),
    "lookup-rows-model": (("minitron-train-sp",), "all-to-all", "model", "gather", _LOOKUP),
    "lookup-rows-data": (("minitron-train-sp",), "all-to-all", "data", "gather", _LOOKUP),
    "cache-rows": (("olmo-prefill",), "all-gather", "data", "scatter",
                   "The prefill's K/V cache write gathers every batch row's K and V "
                   "(f32[32,32768,16,128]) over 'data' before scattering them into a cache "
                   "whose batch is data-sharded; each rank writes its own rows."),
    "cache-heads": (("olmo-prefill",), "all-gather", "model", "scatter",
                    "K and V (f32[8,32768,16,128]), computed on the rank's sequence shard, "
                    "are gathered whole over 'model' and sliced back into the "
                    "sequence-sharded cache; each rank writes its own slots."),
    "decode-lookup": (("olmo-decode",), "all-to-all", "data", "gather",
                      "XLA's 'Involuntary full rematerialization' of the embedding lookup "
                      "(bf16[128,1,1024] gather): the rows are replicated, then "
                      "repartitioned."),
    "decode-lookup-rows": (("olmo-decode",), "all-gather", "pod", "gather",
                           "The same rematerialization: the lookup's f32[128,1,1024] rows "
                           "gathered over 'pod'."),
    "decode-cache-rows": (("olmo-decode",), "all-gather", "pod+data", "scatter",
                          "The decode step's K/V write gathers the new token of every batch "
                          "row (f32[128,1,16,128]) over the batch axes before the scatter."),
}

@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    return run_jax(CELLS, EXCEPTIONS, tmp_path_factory.mktemp("jaxcoll") / "records.json",
                   JAX_TIMEOUT_S)


@pytest.fixture(scope="module")
def port_records():
    return run_port(CELLS)


def test_every_exception_takes_out_bytes(jax_records):
    """Each named exception matches HLO instructions in its cells."""
    for i, (cells, *_rest) in EXCEPTIONS.items():
        for cid in cells:
            assert jax_records[cid]["excepted"][i] > 0, (i, cid)
    # the attention weights' all-to-all is the records' whole all-to-all
    for cid in EXCEPTIONS["attention-scores"][0]:
        rec = jax_records[cid]
        assert rec["excepted"]["attention-scores"] == pytest.approx(rec["kinds"]["all-to-all"])
    # K and V whole (f32), 16 layers, and their s32 slot indices
    cache = 16 * 2 * 8 * 32768 * 16 * 128 * 4
    assert cache <= jax_records["olmo-prefill"]["excepted"]["cache-heads"] <= 1.001 * cache


@pytest.mark.parametrize("cid", list(CELLS))
def test_plan_within_the_jax_record(jax_records, port_records, cid):
    assert_within(jax_normalised(jax_records[cid], cid, EXCEPTIONS),
                  port_normalised(port_records[cid]), cid)


def _model_bytes(by_axis):
    return sum(v for axes, v in by_axis.items() if "model" in axes.split("+"))


def _port_model_bytes(rec):
    """The port's bytes over "model", a reduce-scatter counted as the
    all-reduce of its input."""
    m = rec["mesh_shape"]["model"]
    return sum(v * (m if kind == "reduce-scatter" else 1)
               for kind, axes in rec["collectives"]["by_kind_axis"].items()
               for a, v in axes.items() if "model" in a.split("+"))


def test_sequence_parallel_sends_more_over_model(jax_records, port_records):
    """In both packages the SP cell moves more bytes over "model" than the
    cell without SP, counted as the JAX records count them (the port's
    reduce-scatters as all-reduces of their inputs; JAX's with the attention
    weights' all-to-all taken out), and the two records share a variant
    tag, and so a key.  In result bytes the port's SP moves less: its
    reduce-scatters return a shard."""
    sp, none = port_records["olmo-train-sp"], port_records["olmo-train-none"]
    assert _port_model_bytes(sp) > _port_model_bytes(none)
    assert (_model_bytes(sp["collectives"]["by_axis"])
            < _model_bytes(none["collectives"]["by_axis"]))
    assert sp["variant"] == none["variant"] == {}
    j_sp, j_none = jax_records["olmo-train-sp"], jax_records["olmo-train-none"]
    scores = j_sp["excepted"]["attention-scores"]
    assert _model_bytes(j_sp["by_axis"]) - scores > _model_bytes(j_none["by_axis"])


@pytest.mark.parametrize("cid", ["olmo-train-sp", "olmo-train-none", "moe-train-sp",
                                 "minitron-train-sp"])
def test_train_flops_within_3_percent_of_jax(jax_records, port_records, cid):
    jax, port = jax_records[cid]["flops_per_device"], port_records[cid]["flops_per_device"]
    assert abs(port / jax - 1) <= 0.03, (cid, port / jax)


@pytest.mark.parametrize("cid", list(CELLS))
def test_memory_within_the_jax_record(jax_records, port_records, cid):
    """The memory proof: a device's argument, output and alias bytes from
    the port's trace against the record's ``memory_analysis()``."""
    assert_memory_within(jax_records[cid]["memory"], port_records[cid]["memory"], cid)
