"""The plain reference against the port, in float32 at a tiny size on the
CPU, on the benchmark's own weights; and the weights' layout against the
port's ``LM.init``."""

import numpy as np
import pytest
import torch

from port_bench.harness import load_cell, use_program
from port_bench.reference import dense as ref
from port_bench.weights import make_dense

from .tiny import MODEL, bench

use_program()

from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.transformer import LM  # noqa: E402
from repro_torch.optim.optimizers import AdamW  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

CPU = torch.device("cpu")


def model(cell, **over):
    m = dict(load_cell(bench(), cell).config["model"], **MODEL, dtype="float32")
    if cell.startswith("qwen"):
        m["n_kv_heads"] = m["n_heads"]
    m.update(over)
    return m


def shapes(tree):
    return [(k, tuple(v.shape), v.dtype) for k, v in ref.leaves(tree)]


@pytest.mark.parametrize("cell", ["minitron-8b.rag", "qwen1.5-0.5b.train"])
def test_weights_laid_out_as_the_port_makes_them(cell):
    m = model(cell, dtype="bfloat16")
    mine = make_dense(m, 1, CPU)
    port = LM(ModelConfig(**m), device=CPU).init(torch.Generator(device=CPU).manual_seed(0))
    assert shapes(mine) == shapes(port)


@pytest.mark.parametrize("cell", ["minitron-8b.rag", "qwen1.5-0.5b.train"])
def test_serving_logits_match_the_port(cell):
    m = model(cell)
    params = make_dense(m, 5, CPU)
    lm = LM(ModelConfig(**m), device=CPU)
    prompt = torch.randint(0, m["vocab"], (1, 11), generator=torch.Generator().manual_seed(1))
    caches = lm.init_cache(1, 32)
    logits = [lm.prefill(params, {"tokens": prompt}, caches)[0][0]]
    toks = [int(logits[0].argmax())]
    pos = torch.tensor([prompt.shape[1]], dtype=torch.int32)
    for _ in range(5):
        out, caches = lm.decode_step(params, torch.tensor([toks[-1]]), pos, caches)
        logits.append(out[0])
        toks.append(int(out[0].argmax()))
        pos = pos + 1
    seq = torch.cat([prompt[0], torch.tensor(toks[:-1])])
    ref.exact_matmul()
    h = ref.hidden_states(m, params, [seq], [prompt.shape[1] - 1])[0]
    want = h @ ref.head(m, params)
    got = torch.stack(logits)
    assert torch.allclose(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
    gaps = ref.logit_gaps(ref.head(m, params), h, torch.tensor(toks))
    assert float(gaps.max()) < 1e-4 * float(want.abs().max())


def test_training_steps_match_the_port():
    m = model("qwen1.5-0.5b.train")
    opt = {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.0,
           "clip_norm": None}
    params = make_dense(m, 9, CPU)
    params0 = {k: v for k, v in ref.leaves(params)}
    p0 = torch.utils._pytree.tree_map(lambda t: t.clone(), params)
    g = torch.Generator().manual_seed(2)
    batches = []
    for _ in range(2):
        ids = torch.randint(0, m["vocab"], (2, 17), generator=g)
        batches.append((ids[:, :-1], ids[:, 1:]))
    step = make_train_step(LM(ModelConfig(**m), device=CPU),
                           AdamW(lr=opt["lr"], b1=0.9, b2=0.95, eps=1e-8, clip_norm=None))
    state = AdamW(lr=opt["lr"], clip_norm=None).init(params)
    losses = []
    for tok, lab in batches:
        params, state, out = step(params, state, {"tokens": tok, "labels": lab})
        losses.append(float(out["loss"]))
    want = ref.train_steps(m, p0, batches, opt)
    assert np.allclose(losses, want["losses"], rtol=1e-5)
    for k, v in ref.leaves(params):
        # Adam divides by sqrt(v): where a gradient is all but zero (the slow rotary
        # pairs of a key's bias, nearly constant under softmax) the rounding of another
        # summation order moves an element by up to lr; those elements are left out
        g = want["grads1"][k].abs()
        live = g > 1e-3 * g.max()
        assert torch.allclose(v[live], want["params"][k][live], atol=1e-5), k
    assert set(params0) == set(want["params"])
