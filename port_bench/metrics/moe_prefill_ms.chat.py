"""Model layer (``moe_apply``, the program's ``model.moe`` span, one an
expert layer): the device time of a prefill's expert layers (router,
dropless dispatch, the experts' grouped products, the shared experts),
summed over each ``model.prefill`` of the kept profile, mean over them.
A prefill lands between two decode steps and holds every busy slot's next
token: the widest gaps between tokens are a step and a prefill."""
from port_bench.step_spans import prefill_device_ms


def read(rec):
    return prefill_device_ms(rec, "model.moe")
