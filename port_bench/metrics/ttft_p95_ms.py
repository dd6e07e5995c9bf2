"""95th percentile, over every request due in the window, of the time from
its due time to its first token on the host.  A request still without one
when the loop gave up (the mix's drain after the window) counts with the
time it had waited by then."""
import numpy as np


def read(rec):
    reqs = [r for r in rec.requests if r.due is not None]
    if not reqs:
        return None
    stop = rec.seconds + rec.cell.mix.get("drain_s", 0.0)
    waits = [(r.first if r.first is not None else max(stop, r.due)) - r.due for r in reqs]
    return 1e3 * float(np.percentile(waits, 95))
