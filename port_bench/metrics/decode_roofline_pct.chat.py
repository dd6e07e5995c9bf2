"""Model layer (the whole decode step): the least time of the traced span's
steps over their device time (``decode_device_ms.chat``), in percent.  A
step's least time (``costs_moe.decode_least_s``) is the larger of its
operations at the bf16 peak and its bytes at the HBM peak: every weight
but the embedding once, the head once, and the busy slots' latent cache at
their lengths, from the harness's ``step`` spans (busy slots, their lengths
summed)."""
import numpy as np

from port_bench import costs_moe
from port_bench.readers import traced_spans
from port_bench.step_spans import decode_device_ms


def read(rec):
    if rec.trace is None:
        return None
    device = decode_device_ms(rec)
    steps = traced_spans(rec, "step")
    if device is None or device <= 0 or not steps:
        return None
    least = np.mean([costs_moe.decode_least_s(rec.model, s.attrs["batch"], s.attrs["live_slots"])
                     for s in steps])
    return 100.0 * 1e3 * float(least) / device
