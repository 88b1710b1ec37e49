from . import keyframe, optimizer, pcm, pipeline, posegraph, vocab  # noqa: F401
