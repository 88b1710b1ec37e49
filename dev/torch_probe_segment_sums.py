"""The 4-DoF solve's segment sums in three forms, on one CUDA card: the
dry run's 1024-keyframe / 6400-edge problem (`entry.dryrun_problems`), 12
LM x 60 CG, with `optimizer._segments` / `optimizer._seg_sum` patched to

- "index_add_": `zeros.index_add_(0, idx, vals)` (atomic adds, the form
  before the solve was graphed);
- "index_put_": `zeros.index_put_((idx,), vals, accumulate=True)` (sorts
  the indices on every call);
- "segment_reduce" (committed): the edges sorted once a solve, then
  `torch.segment_reduce` over the sorted rows.

For each: two eager solves (are their bits equal?), the eager seconds, the
graphed solve's seconds (the call that captures, then a replay) and a
replay's device busy and device activities under the profiler, and whether
the replay's bits equal the eager solve's.

    python3 dev/torch_probe_segment_sums.py     # from the repo's root; needs a card
"""

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from cvids_tpu_torch.entry import dryrun_problems  # noqa: E402
from cvids_tpu_torch.server import optimizer as opt  # noqa: E402


def _by_index(accumulate):
    """(segments, seg_sum) that keep the unsorted node index and the node
    count in a `_Segments` and accumulate into zeros on every call."""
    def segments(idx, n):
        return opt._Segments(idx, n)

    def seg_sum(vals, seg):
        out = torch.zeros((seg.offsets,) + vals.shape[1:], dtype=vals.dtype,
                          device=vals.device)
        return accumulate(out, seg.perm, vals)
    return segments, seg_sum


FORMS = {
    "index_add_": _by_index(lambda out, idx, vals: out.index_add_(0, idx, vals)),
    "index_put_": _by_index(lambda out, idx, vals: out.index_put_((idx,), vals,
                                                                  accumulate=True)),
    "segment_reduce": (opt._segments, opt._seg_sum),
}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> None:
    dev = torch.device("cuda", 0)
    nodes, edges = dryrun_problems(1, dev, production=True)["graph"]
    committed = (opt._segments, opt._seg_sum)
    for name, (segments, seg_sum) in FORMS.items():
        opt._segments, opt._seg_sum = segments, seg_sum
        opt._GRAPHED = None                      # a fresh graph for each form
        eager, eager_s = timed(lambda: opt.optimize_pose_graph(nodes, edges, 12, 60))
        again, _ = timed(lambda: opt.optimize_pose_graph(nodes, edges, 12, 60))
        _, capture_s = timed(lambda: opt.optimize_pose_graph_graphed(nodes, edges, 12, 60))
        graphed, replay_s = timed(lambda: opt.optimize_pose_graph_graphed(nodes, edges, 12, 60))
        _, rows = cs.profile_frame(lambda: opt.optimize_pose_graph_graphed(nodes, edges, 12, 60))
        print(f"{name:15s} eager {eager_s:.4f} s, two eager solves bit-equal "
              f"{all(cs._same_bits(x, y) for x, y in zip(eager, again))}; graphed: capturing "
              f"call {capture_s:.4f} s, replay {replay_s:.4f} s, device busy "
              f"{sum(r[1] for r in rows) / 1e3:.4f} s over {sum(r[2] for r in rows)} device "
              f"activities, bit-equal to eager "
              f"{all(cs._same_bits(x, y) for x, y in zip(graphed, eager))}", flush=True)
    opt._segments, opt._seg_sum = committed


if __name__ == "__main__":
    main()
