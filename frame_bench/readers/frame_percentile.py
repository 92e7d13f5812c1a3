"""A percentile of the times of every frame of the window: the interval
between consecutive frames' end marks (numpy's linear percentile)."""

import numpy as np


def read(ctx, q, **_):
    iv = ctx["window"]["intervals_ms"]
    return float(np.percentile(iv, q)) if iv else None
