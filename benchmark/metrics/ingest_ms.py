"""Host ms a keyframe of the pose graph's ingest (the server's `ingest`
span: BoW query and insert, the loop cascade, PCM and the solve's trigger),
over the window."""

from benchmark.metrics._spans import ms_per_call


def read(run):
    return ms_per_call(run, "ingest")
