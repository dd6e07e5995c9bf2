"""Model layer (``LM.decode_graph``, the ``replay`` attribute of the
program's ``model.decode_step`` span inside each ``serve.step``): the share
of the kept profile's decode steps that replayed the step's CUDA graphs, in
percent.  None where the program's spans carry no such attribute."""
from port_bench.program_spans import kept_spans, of_kind


def read(rec):
    spans = kept_spans(rec)
    steps = of_kind(spans, "model.decode_step", "serve.step") if spans else []
    if not any("replay" in s.attrs for s in steps):
        return None
    return 100.0 * sum(s.attrs.get("replay") is True for s in steps) / len(steps)
