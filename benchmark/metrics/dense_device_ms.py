"""Device ms a fused keyframe of the dense layer: the activities launched
inside the `depth` span and outside `fuse` and `remap` (the frame's graph
replay and a new reference's start), over the dense graph's replays in the
profiled slice."""


def read(run):
    tr, n = run.trace, run.window.slice_counters.get("dense_replays", 0)
    if tr is None or not n:
        return None
    return 1e3 * tr.device_s({"depth"}, {"fuse", "remap"}) / n
