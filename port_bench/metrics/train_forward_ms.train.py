"""Trainer layer (``model.loss`` in ``value_and_grad``, the program's
``train.forward`` span): its device time in the kept profile, from two CUDA
events a span (the stream's elapsed time between them, which is busy time
where the card stays behind the host, as in training), over the profile's
``train.step`` spans, in ms a step."""
from port_bench.program_spans import per_step_device_ms


def read(rec):
    return per_step_device_ms(rec, "train.forward")
