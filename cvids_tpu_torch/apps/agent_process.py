"""One agent of the reference's deployment topology, as its own process: an
`AgentFrontend` on an EuRoC-format sequence, every frame fed with the IMU
since the previous one, each keyframe packet published over TCP by
`io.transport.AgentSocketSender` (the reference's VIO node publishing
`AgentMsg` and the keyframe image, `collaborative_server_system.cpp:70-77`).

`agent_main` is the target of a spawned process (a process that holds a
CUDA context cannot fork one that uses the card). It saves what it sent,
the codec dicts of every packet, and its per-frame host times to an `.npz`,
so that the server side can check the wire bit for bit.

    python -m cvids_tpu_torch.apps.agent_process --seq DIR --client 0 --port P [--out F]
        [--device cpu] [--threads N]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..io import codec, euroc
from ..io.transport import AgentSocketSender

__all__ = ["imu_batches", "run_agent", "agent_main", "load_sent"]


def imu_batches(seq: euroc.EurocSequence, frame_ids):
    """(frame index, time, gyr, acc, dts) per frame: the IMU since the
    previous frame, and for the first frame the accelerometer of the 0.1 s
    before it (as the JAX package's examples and tests feed a front-end)."""
    prev_t = None
    for fi in frame_ids:
        t = seq.cam_t[fi]
        if prev_t is None:
            sel = (seq.imu_t >= t - 0.1) & (seq.imu_t < t)
            yield fi, t, np.zeros((0, 3)), seq.acc[sel], np.zeros(0)
        else:
            sel = (seq.imu_t >= prev_t) & (seq.imu_t < t)
            yield fi, t, seq.gyr[sel], seq.acc[sel], np.diff(np.append(seq.imu_t[sel], t))
        prev_t = t


def run_agent(root: str, client_id: int, port: int, out: str | None = None,
              device=None, host: str = "127.0.0.1", threads: int | None = None):
    """Track every frame of the sequence at `root` with the calibration of
    its `sensor.yaml` files, on `device` (None: the card), publishing each
    packet to `host:port`. Saves the sent codec dicts and the frame times
    to `out` when given. `threads` sets this process's intra-op threads
    (None keeps torch's default; agents that share a machine's cores on the
    CPU want 1). Returns the front-end."""
    from ..utils.config import AgentConfig
    from ..vio.frontend import AgentFrontend

    dev = resolve_device(device)
    if threads is not None:
        torch.set_num_threads(threads)
    seq = euroc.load_euroc(root)
    cfg = euroc.load_agent_config(root) or AgentConfig()
    fe = AgentFrontend(cfg, client_id, device=device)
    sender = AgentSocketSender(host, port)
    sent, frame_ms, keyframe = [], [], []
    try:
        for fi, t, gyr, acc, dts in imu_batches(seq, range(len(seq.cam_t))):
            img = seq.load_image(fi)
            kf0 = fe.kf_count
            t0 = time.perf_counter()
            pkt = fe.process_frame(t, img, gyr, acc, dts)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            keyframe.append(fe.kf_count > kf0)
            if pkt is not None:
                sender.send_packet(pkt)
                sent.append(codec.encode_packet(pkt))
    finally:
        sender.close()
    if out is not None:
        arrays = {f"{i}.{k}": np.asarray(v) for i, d in enumerate(sent) for k, v in d.items()}
        np.savez(out, frame_ms=np.asarray(frame_ms), keyframe=np.asarray(keyframe, bool),
                 packets=np.int64(len(sent)), **arrays)
    return fe


def load_sent(path: str) -> tuple[list[dict], np.ndarray, np.ndarray]:
    """What `run_agent` saved: (codec dicts in send order, frame ms,
    keyframe flags)."""
    with np.load(path, allow_pickle=False) as z:
        sent = [{} for _ in range(int(z["packets"]))]
        for key in z.files:
            i, dot, field = key.partition(".")
            if dot:
                sent[int(i)][field] = z[key]
        return sent, z["frame_ms"], z["keyframe"]


def agent_main(root: str, client_id: int, port: int, out: str | None = None,
               device=None, threads: int | None = None) -> None:
    """The spawned process's target: `run_agent`, nothing returned (an
    exception gives the process a non-zero exit code)."""
    run_agent(root, client_id, port, out, device, threads=threads)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", required=True, help="EuRoC sequence root (contains mav0/)")
    ap.add_argument("--client", type=int, default=0)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", default=None, help="save the sent packets and frame times here")
    ap.add_argument("--device", default=None, help="default: the card; cpu for a CPU run")
    ap.add_argument("--threads", type=int, default=None, help="intra-op threads (torch's default)")
    args = ap.parse_args(argv)
    fe = run_agent(args.seq, args.client, args.port, args.out, args.device, args.host,
                   args.threads)
    print(f"agent {args.client}: {fe.kf_count} keyframes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
