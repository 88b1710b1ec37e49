"""Host ms a published map (the server's `fuse` span: finalize, the
photometric check, the TSDF integrate and the depth record), over the
window."""

from benchmark.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, "fuse")
