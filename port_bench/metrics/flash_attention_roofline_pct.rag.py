"""Kernel layer (``flash_attention``): the least time of the traced
prefills' attention calls (one a layer; operations or bytes from each
prompt's shape) over the kernel's device time in the trace, in percent."""
from port_bench.readers import attention_least_s, roofline_pct, traced_spans


def read(rec):
    if rec.trace is None:
        return None
    m = rec.model
    least = sum(m["n_layers"] * attention_least_s(m, 1, s.attrs["tokens"])
                for s in traced_spans(rec, "prefill"))
    return roofline_pct(rec, "flash_attention", least)
