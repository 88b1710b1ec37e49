"""The 95th percentile of keyframe latency, submission to completion, over
every keyframe of the window (host clock)."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
