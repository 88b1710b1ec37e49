"""Host ms a dense reference roll (the server's `roll` span: the new
reference's host inputs, their upload and the roll itself, a graph replay
on the card), over the window; nothing on a program without the span."""

from benchmark.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, "roll")
