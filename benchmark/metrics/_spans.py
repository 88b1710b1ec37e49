"""Shared by the span readers: a `Tracer` span's host ms a call over the
window."""


def ms_per_call(run, name):
    total, count = run.spans.get(name, (0.0, 0))
    return 1e3 * total / count if count else None
