"""The port's collective plan held against the JAX dry-run's records on the
prefill cells of the mixtures of experts: DeepSeek-V3 (MLA, 256 routed
experts) and Qwen1.5-MoE-A2.7B (60 routed experts, MHA), at ``prefill_32k``
on data 4 x model 2 under sequence parallelism.

The records are taken and read as ``_jax_collectives`` describes, each
cell from its probes alone; the bounds are ``test_torch_collectives.py``'s:
the total within a factor of 1.5, each of all-gather, all-reduce and
all-to-all within 2 (a kind under 1% of both totals excepted).  Each MoE
layer's all-reduce over "model" is two (T, d) reductions in the records'
HLO, combined into one instruction: the shared experts' down projection
(a dot of the gathered stream's shared MLP with the model-sharded wo) and
the routed combine (the "gsec,gecd->gsd" dot over the rank's experts).
The plan prices both (``dryrun._shared_beside_routed``).  The JAX
fixture (both cells' probes in one subprocess) took 15.5 s alone and 22.4
s beside the other JAX-record files under six workers (``-n 6 --dist
loadfile``); its timeout leaves room for a crowded host.
"""
import pytest

from _jax_collectives import (
    assert_within,
    jax_normalised,
    jax_records as run_jax,
    port_normalised,
    port_records as run_port,
)

JAX_TIMEOUT_S = 180

CELLS = {
    "deepseek-prefill": ("deepseek-v3-671b", "prefill_32k", "single", {}),
    "moe-prefill": ("qwen2-moe-a2.7b", "prefill_32k", "single", {}),
}

_ROWS = ("The prefill's cache write gathers every batch row's {what} over 'data' before "
         "scattering them into a cache whose batch is data-sharded; each rank writes its own "
         "rows.")
_HEADS = ("The {what}, computed on the rank's sequence shard, are gathered whole over "
          "'model' and sliced back into the sequence-sharded cache; each rank writes its own "
          "slots.")
# id: (cells, kind, axes, op_name tail, reason)
EXCEPTIONS = {
    "cache-rows": (("deepseek-prefill", "moe-prefill"), "all-gather", "data", "scatter",
                   _ROWS.format(what="K and V (MLA: the latent and the rope key, "
                                "f32[32,32768,512] and f32[32,32768,64]; Qwen-MoE: "
                                "f32[32,32768,16,128]) and their slot indices")),
    "cache-heads": (("deepseek-prefill", "moe-prefill"), "all-gather", "model", "scatter",
                    _HEADS.format(what="K and V (MLA: the latent and the rope key) and "
                                  "their slot indices")),
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


@pytest.mark.parametrize("cid", list(CELLS))
def test_moe_all_reduce_equals_the_record(jax_records, port_records, cid):
    """The shared experts' and the routed combine's reductions over "model",
    as an H100 program sends them, equal the record's all-reduce, with no
    exception (each MoE layer two (T, d) reductions)."""
    jax = jax_normalised(jax_records[cid], cid, EXCEPTIONS)["all-reduce"]
    port = port_normalised(port_records[cid])["all-reduce"]
    assert abs(port / jax - 1) <= 1e-6, (cid, port, jax)


@pytest.mark.parametrize("cid", list(CELLS))
def test_plan_within_the_jax_record(jax_records, port_records, cid):
    assert_within(jax_normalised(jax_records[cid], cid, EXCEPTIONS),
                  port_normalised(port_records[cid]), cid)
