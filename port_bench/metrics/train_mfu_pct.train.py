"""Model and trainer layer (``make_train_step``): 6 x the product weights
(layers and head) x the tokens, plus the causal attention's forward and
backward, for every step the window completed, over its length at the
card's bf16 peak, in percent."""
from port_bench import costs


def read(rec):
    mix = rec.cell.mix
    if not rec.steps or rec.elapsed <= 0:
        return None
    flops = rec.steps * costs.train_step_flops(rec.model, mix["batch"], mix["seq"])
    return 100.0 * flops / (rec.elapsed * costs.PEAK_FLOPS_BF16)
