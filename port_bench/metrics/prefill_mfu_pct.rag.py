"""Model layer (``LM.prefill``): the model operations of the window's
prefills (2 x the layers' product weights x the prompt's tokens, causal
attention, the last token's logits) over their summed host time at the
card's bf16 peak, in percent."""
from port_bench import costs
from port_bench.readers import window_spans


def read(rec):
    spans = window_spans(rec, "prefill")
    t = sum(s.t1 - s.t0 for s in spans)
    if not spans or t <= 0:
        return None
    flops = sum(costs.prefill_flops(rec.model, s.attrs["tokens"]) for s in spans)
    return 100.0 * flops / (t * costs.PEAK_FLOPS_BF16)
