"""Host ms a call of the dense path's undistortion (the server's `remap`
span), over the window; nothing where the clients' cameras need no remap."""

from benchmark.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, "remap")
