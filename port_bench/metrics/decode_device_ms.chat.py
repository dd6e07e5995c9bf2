"""Model layer (``DecodeGraph``'s replay, the program's ``model.backbone``
and ``model.logits`` spans under each ``model.decode_step`` inside a
``serve.step``): the mean device time of a decode step, the backbone's
graph (embedding, every layer, the final norm) plus the head's, each from
two CUDA events: the stream's elapsed time from its first queued work to
its last."""
from port_bench.step_spans import decode_device_ms as read  # noqa: F401
