"""Host-only inputs of the server: the keyframe packet (`msgs`) and the
synthetic multi-agent streams (`multiagent`, `synthetic`). numpy only."""
