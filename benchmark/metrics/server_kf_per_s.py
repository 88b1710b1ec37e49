"""Keyframes the server completed in the window, over the window's seconds
(host clock; a traced run's profiled slice is in neither)."""


def read(run):
    w = run.window
    n = len(w.latencies_s)
    return n / w.elapsed_s if w.elapsed_s > 0 and n else None
