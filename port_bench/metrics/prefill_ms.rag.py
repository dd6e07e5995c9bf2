"""Engine layer (``ServingEngine.add_request``): the mean host time of the
window's admissions, each a prefill that ends when its first token is on
the host."""
from port_bench.readers import mean_ms, window_spans


def read(rec):
    return mean_ms(window_spans(rec, "prefill"))
