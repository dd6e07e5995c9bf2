"""95th percentile of every gap between two consecutive output tokens of
a request, over all requests, for every token that came inside the window,
on the host clock."""
import numpy as np


def read(rec):
    gaps = []
    for r in rec.requests:
        t = np.asarray(r.token_times)
        if t.size > 1:
            d = np.diff(t)
            gaps.extend(d[t[1:] <= rec.elapsed].tolist())
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
