"""The frozen arithmetic against numbers PERF.md records, and each
configuration file against the published configuration it copies."""
import json

import pytest

from port_bench import costs
from port_bench.harness import ROOT, load_cell

from .tiny import bench

# the published configuration's key -> the port's ModelConfig field
PUBLISHED = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
             "num_attention_heads": "n_heads", "num_key_value_heads": "n_kv_heads",
             "head_dim": "head_dim", "intermediate_size": "d_ff", "vocab_size": "vocab",
             "tie_word_embeddings": "tie_embeddings", "rope_theta": "rope_theta",
             "hidden_act": "act", "torch_dtype": "dtype"}
CONFIGS = [c["file"] for c in bench()["configs"]]


def _published_pairs():
    """(file, key) for every published key the port has a field for and
    that ``reduced`` does not list."""
    out = []
    for file in CONFIGS:
        conf = json.loads((ROOT / file).read_text())
        out += [(file, k) for k in sorted(PUBLISHED)
                if k in conf["published"] and k not in conf["reduced"]]
    return out


def test_train_attention_operations():
    assert costs.attention_work(4, 2048, 16, 16, 64, 2)[0] == 34_376_515_584


def test_parameter_counts():
    b = bench()
    assert costs.param_count(load_cell(b, "minitron-8b.rag").config["model"]) == 8_271_699_968
    assert costs.param_count(load_cell(b, "qwen1.5-0.5b.train").config["model"]) == 463_987_712


def test_weights_count_as_the_arithmetic_does():
    import torch

    from port_bench.reference.dense import leaves
    from port_bench.weights import make_dense

    from .tiny import MODEL

    for over in ({}, {"qkv_bias": True, "tie_embeddings": True, "mlp": "swiglu",
                      "act": "silu", "norm": "rmsnorm"}):
        m = dict(load_cell(bench(), "minitron-8b.rag").config["model"], **MODEL, **over)
        p = make_dense(m, 3, torch.device("cpu"))
        assert sum(t.numel() for _, t in leaves(p)) == costs.param_count(m)


@pytest.mark.parametrize("file,key", _published_pairs())
def test_config_keeps_the_published_value(file, key):
    """Every published value the port has a field for is run as published,
    unless ``reduced`` lists its key."""
    conf = json.loads((ROOT / file).read_text())
    assert conf["model"][PUBLISHED[key]] == conf["published"][key], key


@pytest.mark.parametrize("file", CONFIGS)
def test_reduced_names_published_keys_and_no_width(file):
    conf = json.loads((ROOT / file).read_text())
    for key in conf["reduced"]:
        assert key in conf["published"], key
        assert not key.endswith(("_dim", "_rank", "_size")) and "heads" not in key, key


def test_peaks():
    assert costs.PEAK_FLOPS_BF16 == 989e12 and costs.HBM_BYTES_PER_S == 3.35e12
    assert (ROOT / "port_bench" / "costs.py").is_file()
