"""Kernel layer (``flash_attention``, the forward in every layer of every
step; its backward is plain torch): the least time of the traced calls,
as many as the program counted while the profile ran, each at the
step's shape, over the kernel's device time in the trace, in percent."""
from port_bench.readers import attention_least_s, roofline_pct


def read(rec):
    if rec.trace is None:
        return None
    m, mix = rec.model, rec.cell.mix
    calls = rec.trace.expected.get("flash_attention", 0)
    return roofline_pct(rec, "flash_attention",
                        calls * attention_least_s(m, mix["batch"], mix["seq"]))
