"""Model layer (``LM.prefill``, the program's ``model.prefill`` span): the
mean device time of the kept profile's prefills, from two CUDA events: the
stream's elapsed time from a prefill's first queued work to its last.  The
host paces a prefill's kernels, so that time holds the card's idle gaps
too, and it is not the card's busy time."""
from port_bench.program_spans import device_ms, kept_spans, of_kind


def read(rec):
    spans = kept_spans(rec)
    return device_ms(of_kind(spans, "model.prefill")) if spans else None
