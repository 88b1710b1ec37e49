"""Phase 8's front-end on the card, broken down by `Tracer` span: where a
camera frame's time, device work and host syncs go.

    python3 dev/torch_probe_frontend_spans.py [--package DIR] [--cache FILE]

Renders phase 8's seed-0 sequences (`chip_smoke.agent_sequences`; with
`--cache` they are kept in FILE, under build/, and read back by later runs)
and feeds every frame of both agents through `AgentFrontend` on the card,
as phase 8 does, three ways in one pass over agent 0:

- every frame outside the two windows below: host ms a frame with the device
  synced after it (plain frames and keyframes apart, both agents), and each
  span's host ms;
- agent 0's frames 40-79: host syncs (torch's sync debug mode), each
  charged to the span it happened in;
- agent 0's frames 80-119: each frame under `torch.profiler`, the device
  synced at the end of every span so that each device activity falls in
  the span that issued it: each span's device ms and device activities a
  call, and each frame's activities and busy share.

With `--package DIR` it imports `cvids_tpu_torch` from DIR (an unpacked
`git archive` of another commit), so two trees are compared in turns in one
call (parent, change, change, parent):

    for t in build/parent . . build/parent; do
        python3 dev/torch_probe_frontend_spans.py --package $t --cache build/frames.pkl; done

Prints one JSON line.
~1.5 minutes a tree on an H100 after the first rendering (~1 minute).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pickle
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SYNC_WINDOW = (40, 80)
PROFILE_WINDOW = (80, 120)
OUTSIDE = "(outside spans)"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", default=None)
    ap.add_argument("--cache", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.package:
        sys.path.insert(0, str(Path(args.package).resolve()))
    import numpy as np
    import torch

    import chip_smoke as cs
    import cvids_tpu_torch
    from cvids_tpu_torch.utils.tracing import Tracer
    from cvids_tpu_torch.vio.frontend import AgentFrontend

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cfg = cs.agent_config()
    cache = Path(args.cache) if args.cache else None
    if cache is not None and cache.exists():
        seqs = pickle.loads(cache.read_bytes())
    else:
        seqs = cs.agent_sequences(cfg)
        for s in seqs:
            s["images"] = [im.astype(np.uint8) for im in s["images"]]
        if cache is not None:
            cache.parent.mkdir(parents=True, exist_ok=True)
            cache.write_bytes(pickle.dumps(seqs))
    for s in seqs:
        s["images"] = [im.astype(np.float32) for im in s["images"]]

    # spans: the current one's name for the sync counter, and, while a
    # frame is profiled, a device sync at every span's end
    state = {"span": OUTSIDE, "sync_at_exit": False}
    real_span = Tracer.span

    @contextlib.contextmanager
    def span(self, name):
        state["span"] = name
        try:
            with real_span(self, name):
                yield
                if state["sync_at_exit"]:
                    torch.cuda.synchronize()
        finally:
            state["span"] = OUTSIDE

    Tracer.span = span

    class Syncs(cs.SyncCounter):
        def __enter__(self):
            super().__enter__()
            self.by_span = defaultdict(int)
            import warnings
            inner = warnings.showwarning

            def count(message, category, *a, **k):
                before = self.count
                inner(message, category, *a, **k)
                if self.count > before:
                    self.by_span[state["span"]] += 1

            warnings.showwarning = count
            return self

    from torch.profiler import ProfilerActivity, profile

    tracer = Tracer(use_profiler=True)
    fes = [AgentFrontend(cfg, cid, device=dev, tracer=tracer) for cid in range(len(seqs))]
    rows, syncs, span_calls_sync = [], None, defaultdict(int)
    dev_ms, dev_acts, span_calls_prof = defaultdict(float), defaultdict(int), defaultdict(int)
    frame_prof = []
    host = defaultdict(list)
    for cid, (seq, fe) in enumerate(zip(seqs, fes)):
        prev_t = None
        for fi, t in enumerate(seq["cam_t"]):
            if prev_t is None:
                sel = (seq["imu_t"] >= t - 0.1) & (seq["imu_t"] < t)
                imu = (np.zeros((0, 3)), seq["acc"][sel], np.zeros(0))
            else:
                sel = (seq["imu_t"] >= prev_t) & (seq["imu_t"] < t)
                ts = seq["imu_t"][sel]
                imu = (seq["gyr"][sel], seq["acc"][sel], np.diff(np.append(ts, t)))
            prev_t = t
            kf0 = fe.kf_count
            n_before = {k: len(v) for k, v in tracer.samples.items()}
            in_sync = cid == 0 and SYNC_WINDOW[0] <= fi < SYNC_WINDOW[1]
            in_prof = cid == 0 and PROFILE_WINDOW[0] <= fi < PROFILE_WINDOW[1]
            if in_sync and fi == SYNC_WINDOW[0]:
                syncs = Syncs().__enter__()
            torch.cuda.synchronize()
            if in_prof:
                state["sync_at_exit"] = True
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fe.process_frame(t, seq["images"][fi], *imu)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                state["sync_at_exit"] = False
                evs = prof.events()
                spans = [(e.time_range.start, e.time_range.end, e.name) for e in evs
                         if e.device_type == torch.autograd.DeviceType.CPU
                         and e.name in tracer.samples]
                busy, acts = 0.0, 0
                for e in evs:
                    # the profiler also draws each span on the device's
                    # timeline (a gpu_user_annotation named after it): skip it
                    if e.device_type != torch.autograd.DeviceType.CUDA or e.name in tracer.samples:
                        continue
                    d_us = e.time_range.end - e.time_range.start
                    name = next((s[2] for s in spans if s[0] <= e.time_range.start <= s[1]),
                                OUTSIDE)
                    dev_ms[name] += d_us / 1e3
                    dev_acts[name] += 1
                    busy += d_us / 1e3
                    acts += 1
                for s in spans:
                    span_calls_prof[s[2]] += 1
                frame_prof.append({"kf": fe.kf_count > kf0, "wall_ms": wall, "busy_ms": busy,
                                   "activities": acts})
            else:
                t0 = time.perf_counter()
                fe.process_frame(t, seq["images"][fi], *imu)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                if not in_sync:
                    for k, v in tracer.samples.items():
                        host[k] += [x * 1e3 for x in list(v)[n_before.get(k, 0):]]
            if in_sync:
                for k, v in tracer.samples.items():
                    span_calls_sync[k] += len(v) - n_before.get(k, 0)
            if syncs is not None and fi == SYNC_WINDOW[1] - 1 and cid == 0:
                syncs.__exit__(None, None, None)
            rows.append((cid, fi, fe.kf_count > kf0, wall, in_prof or in_sync))

    def stats(v):
        v = np.asarray(v, np.float64)
        return ({"median": float(np.median(v)), "p90": float(np.percentile(v, 90)), "n": len(v)}
                if len(v) else None)

    n_sync = SYNC_WINDOW[1] - SYNC_WINDOW[0]
    names = sorted(set(host) | set(dev_ms) | set(syncs.by_span))
    table = {}
    for name in names:
        calls = span_calls_prof.get(name, 0)
        table[name] = {
            "host_ms": stats(host.get(name, [])),
            "device_ms_per_call": dev_ms[name] / calls if calls else None,
            "activities_per_call": dev_acts[name] / calls if calls else None,
            "syncs_per_call": (syncs.by_span[name] / span_calls_sync[name]
                               if span_calls_sync.get(name) else None),
            "device_ms_per_frame": dev_ms[name] / len(frame_prof),
            "activities_per_frame": dev_acts[name] / len(frame_prof),
            "syncs_per_frame": syncs.by_span[name] / n_sync,
        }
    timed = [r for r in rows if not r[4]]
    row = {"probe": "frontend_spans", "package": str(Path(cvids_tpu_torch.__file__).parent),
           "card": smi, "torch": torch.__version__,
           "plain_ms": stats([r[3] for r in timed if not r[2]]),
           "keyframe_ms": stats([r[3] for r in timed if r[2]]),
           "mean_frame_ms": float(np.mean([r[3] for r in timed])),
           "syncs_per_frame": syncs.count / n_sync,
           "profiled_frames": len(frame_prof),
           "activities_per_frame": stats([f["activities"] for f in frame_prof]),
           "activities_per_plain_frame": stats([f["activities"] for f in frame_prof
                                                if not f["kf"]]),
           "busy_share_synced_spans": (sum(f["busy_ms"] for f in frame_prof)
                                       / sum(f["wall_ms"] for f in frame_prof)),
           "keyframes": [f.kf_count for f in fes], "track_stats": fes[0].track_stats,
           "spans": table}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
