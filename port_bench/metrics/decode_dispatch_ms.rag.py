"""Model layer (``LM.decode_step``, the program's ``model.decode_step``
span inside each ``serve.step``): the mean host time the kept profile's
steps took to issue every layer's kernels and the head's.  Read under the
profiler, which slows the host: the untraced dispatch is shorter."""
from port_bench.program_spans import host_ms, kept_spans, of_kind


def read(rec):
    spans = kept_spans(rec)
    return host_ms(of_kind(spans, "model.decode_step", "serve.step")) if spans else None
