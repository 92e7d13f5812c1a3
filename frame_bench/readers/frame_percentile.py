"""A percentile of the times of every frame of the window: the interval
between consecutive frames' end marks (numpy's linear percentile).
skip: intervals left out at the window's start; a traced window's first
interval holds the profiler's start, not a frame."""

import numpy as np


def read(ctx, q, skip=0, **_):
    iv = ctx["window"]["intervals_ms"][int(skip):]
    return float(np.percentile(iv, q)) if iv else None
