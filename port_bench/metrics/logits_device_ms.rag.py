"""Model layer (``LM.logits``, the program's ``model.logits`` span under
each ``model.decode_step``): the mean device time of a decode step's head,
its cast to the logits' dtype and its product, from two CUDA events: the
stream's elapsed time from the head's first queued work to its last."""
from port_bench.program_spans import device_ms, kept_spans, of_kind


def read(rec):
    spans = kept_spans(rec)
    return device_ms(of_kind(spans, "model.logits", "model.decode_step")) if spans else None
