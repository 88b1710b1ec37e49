"""Collective-payload audit of the port's sharded runs (port of
``cvids_tpu/parallel/audit.py``).

The JAX package reads every cross-device collective out of a compiled
program's HLO. The port has no HLO: its collectives are the calls a
`Mesh` issues, and the mesh logs each one (`Mesh.log`: (op, payload bytes)
a call). So the counts here are **calls issued** by a run: a CG step's
all-reduce counts once a step, where JAX's audit counts one static HLO
instruction for the whole loop.
"""

from __future__ import annotations

__all__ = ["collective_payloads", "summarize_collectives"]


def collective_payloads(log) -> list[dict]:
    """[{op, count, bytes}] per collective op in a mesh's log: the calls
    issued and their summed payload bytes, largest first."""
    agg: dict[str, dict] = {}
    for op, nbytes in log:
        rec = agg.setdefault(op, {"op": op, "count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += nbytes
    return sorted(agg.values(), key=lambda r: -r["bytes"])


def summarize_collectives(log, label: str) -> str:
    """One line in the JAX audit's format ("label: all-reduce xN = ... kB",
    or "label: no cross-device collectives"), where N is the calls issued."""
    recs = collective_payloads(log)
    if not recs:
        return f"{label}: no cross-device collectives"
    parts = [f"{r['op']} x{r['count']} = {r['bytes'] / 1e3:.1f} kB" for r in recs]
    total = sum(r["bytes"] for r in recs)
    calls = sum(r["count"] for r in recs)
    return f"{label}: {', '.join(parts)} (total {total / 1e3:.1f} kB in {calls} calls issued)"
