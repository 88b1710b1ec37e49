"""Share of the dense reference rolls replayed as a CUDA graph: calls of the
server's `roll_graph` span (around the replay) over calls of its `roll`
span, over the window; 0 where every roll ran eagerly, nothing on a
program without the `roll` span."""


def read(run):
    n = run.spans.get("roll", (0.0, 0))[1]
    if not n:
        return None
    return run.spans.get("roll_graph", (0.0, 0))[1] / n
