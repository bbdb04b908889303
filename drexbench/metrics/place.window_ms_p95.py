"""95th percentile of the wall time of each service window's
``place_many`` call in the measured (untraced) window (the benchmark's own spans
around the call; the call returns once the card's work is done)."""

import numpy as np


def read(rec):
    vals = rec.spans.seconds("place_many", *rec.window_ns)
    return 1e3 * float(np.percentile(vals, 95)) if vals else None
