"""From process start to the first timed submission: the kernel library's
load (its build on a checkout's first run), the vocabulary, the session,
the server and the warm-up (host clock)."""


def read(run):
    return run.setup_s
