"""Engine layer (``ServingEngine.step``, the program's ``serve.step`` span):
the mean host time of the kept profile's decode steps, from the call to the
tokens on the host.  Read under the profiler, which slows the host: the
untraced step is shorter."""
from port_bench.program_spans import host_ms, kept_spans, of_kind


def read(rec):
    spans = kept_spans(rec)
    return host_ms(of_kind(spans, "serve.step")) if spans else None
