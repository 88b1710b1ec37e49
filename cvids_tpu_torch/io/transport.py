"""Cross-process agent -> server transport (port of
``cvids_tpu/io/transport.py``).

The reference's defining topology is N VIO processes + one server process on
separate hosts, connected by ROS TCPROS topics: agents publish `AgentMsg` on
`/agent_frame` (queue 2000) and the keyframe image SEPARATELY on
`/pose_graph/image` (queue 1000), and the server's AgentProcess thread
timestamp-matches the two streams before building a keyframe
(`collaborative_server_system.cpp:70-77,453-507`). This module reproduces
that process topology over plain TCP sockets with the `io.codec` wire
layout (AgentMsg's 4xint64 descriptor packing):

- `AgentSocketSender` — runs in an agent process; splits each
  `KeyframePacket` into a MSG frame (pose/points/descriptors) and an IMG
  frame (client id + timestamp + pixels) and ships them as independent
  length-prefixed frames, exactly the two-topic contract.
- `CollaborativeSocketServer` — accepts N agent connections, queues MSG/IMG
  frames per client, and pairs them by timestamp with the reference's
  match-or-drop-older loop (`:462-507`: if the heads differ by more than the
  tolerance, the older head is discarded; nothing assumes in-order or
  perfectly-paired streams). Matched packets are submitted to a
  `CollaborativeServer` (or any callback) on a single ingest thread.

Frames: 1-byte kind (0 = MSG, 1 = IMG) + 8-byte big-endian payload length +
payload. Payloads are `np.savez` archives of the codec dict — the same
transport-agnostic form used for file replay, and the same bytes as the JAX
package's, so either package's sender feeds the other's server.

One departure from the JAX server: there an exception in the sink ends the
daemon ingest thread silently and `drain` waits out its whole timeout
(`cvids_tpu/io/transport.py:220-239`). Here the ingest loop keeps the first
exception and stops ingesting; `drain()` raises it at once, and `stop()`
too unless `drain` has (a `RuntimeError` whose cause is the sink's
exception), so that a CUDA error on the server fails with its own message.
"""

from __future__ import annotations

import io as _io
import socket
import struct
import threading
import time
from collections import deque

import numpy as np

from . import codec
from .msgs import KeyframePacket

__all__ = ["AgentSocketSender", "CollaborativeSocketServer",
           "MSG_QUEUE_DEPTH", "IMG_QUEUE_DEPTH"]

_KIND_MSG = 0
_KIND_IMG = 1

# the reference's subscription queue depths (`collaborative_server_system.
# cpp:70-71`): overflow drops the oldest, like a ROS queue
MSG_QUEUE_DEPTH = 2000
IMG_QUEUE_DEPTH = 1000


def _pack(kind: int, arrays: dict) -> bytes:
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    return struct.pack(">BQ", kind, len(payload)) + payload


def _read_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    while n > 0:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


class AgentSocketSender:
    """Agent-side publisher: one TCP connection carrying both topic streams."""

    def __init__(self, host: str, port: int, connect_timeout: float = 10.0):
        self.sock = socket.create_connection((host, port), timeout=connect_timeout)
        self.sock.settimeout(None)
        self._lock = threading.Lock()

    def send_packet(self, pkt: KeyframePacket):
        """Publish one keyframe as the two independent frames (msg + image).

        The image frame is sent FIRST: the reference's image topic typically
        arrives before the (larger) AgentMsg, and the server matcher must
        not rely on any particular order."""
        d = codec.encode_packet(pkt)
        img = d.pop("image", None)
        with self._lock:
            if img is not None:
                self.sock.sendall(_pack(_KIND_IMG, {
                    "client_id": np.int64(pkt.client_id),
                    "timestamp": np.float64(pkt.timestamp),
                    "image": np.asarray(img)}))
            self.sock.sendall(_pack(_KIND_MSG, d))

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_WR)
        except OSError:
            pass
        self.sock.close()


class CollaborativeSocketServer:
    """Server-side ingestion endpoint (the AgentCallback/ImageCallback +
    AgentProcess matching roles).

    `sink` is a `server.pipeline.CollaborativeServer` (uses .submit/.process)
    or any callable taking a KeyframePacket. All submission happens on ONE
    ingest thread — the pipeline itself stays single-threaded, like the
    reference's AgentProcess. The first exception the sink raises stops the
    ingest and is raised again by `drain`, and by `stop` if `drain` has
    not."""

    def __init__(self, sink, host: str = "127.0.0.1", port: int = 0,
                 match_tol: float = 2e-3, process_each: bool = True):
        self.sink = sink
        self.match_tol = float(match_tol)
        self.process_each = process_each
        self._msgs: dict[int, deque] = {}
        self._imgs: dict[int, deque] = {}
        self._qlock = threading.Lock()
        self._stop = False
        self.error: BaseException | None = None
        self._reported = False
        self.packets_matched = 0
        self.msgs_dropped = 0
        self.imgs_dropped = 0
        self.max_queued = 0      # the longest MSG or IMG queue of one client seen
        self._listener = socket.create_server((host, port))
        self.port = self._listener.getsockname()[1]
        self._conn_threads: list[threading.Thread] = []
        self._open_conns = 0
        self._conns_seen = 0
        self._inflight = 0
        self._accept_thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._ingest_wake = threading.Event()
        self._ingest_thread = threading.Thread(target=self._ingest_loop, daemon=True)
        self._accept_thread.start()
        self._ingest_thread.start()

    # ---------- socket side ----------

    def _accept_loop(self):
        self._listener.settimeout(0.2)
        while not self._stop:
            try:
                conn, _ = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._reader, args=(conn,), daemon=True)
            with self._qlock:
                self._open_conns += 1
                self._conns_seen += 1
            t.start()
            self._conn_threads.append(t)

    def _reader(self, conn: socket.socket):
        try:
            while not self._stop:
                hdr = _read_exact(conn, 9)
                if hdr is None:
                    break
                kind, ln = struct.unpack(">BQ", hdr)
                payload = _read_exact(conn, ln)
                if payload is None:
                    break
                data = dict(np.load(_io.BytesIO(payload), allow_pickle=False))
                cid = int(data["client_id"])
                with self._qlock:
                    if kind == _KIND_MSG:
                        q = self._msgs.setdefault(cid, deque())
                        if len(q) >= MSG_QUEUE_DEPTH:
                            q.popleft()
                            self.msgs_dropped += 1
                        q.append(data)
                    else:
                        q = self._imgs.setdefault(cid, deque())
                        if len(q) >= IMG_QUEUE_DEPTH:
                            q.popleft()
                            self.imgs_dropped += 1
                        q.append(data)
                    self.max_queued = max(self.max_queued, len(q))
                self._ingest_wake.set()
        finally:
            conn.close()
            with self._qlock:
                self._open_conns -= 1
            self._ingest_wake.set()

    # ---------- matching + ingestion ----------

    def _match_one(self) -> KeyframePacket | None:
        """The reference's match-or-drop-older loop
        (`collaborative_server_system.cpp:462-507`), across all clients."""
        with self._qlock:
            for cid, mq in self._msgs.items():
                iq = self._imgs.get(cid)
                while mq and iq:
                    tm = float(mq[0]["timestamp"])
                    ti = float(iq[0]["timestamp"])
                    if abs(tm - ti) <= self.match_tol:
                        d = mq.popleft()
                        d["image"] = iq.popleft()["image"]
                        self.packets_matched += 1
                        # mark in-flight under the SAME lock acquisition that
                        # pops the pair: drain() must never observe empty
                        # queues while the packet is between pop and sink
                        self._inflight += 1
                        return codec.decode_packet(d)
                    if tm < ti:        # stale msg: its image never arrived
                        mq.popleft()
                        self.msgs_dropped += 1
                    else:              # stale image
                        iq.popleft()
                        self.imgs_dropped += 1
        return None

    def _ingest_loop(self):
        while not self._stop and self.error is None:
            self._ingest_wake.wait(timeout=0.1)
            self._ingest_wake.clear()
            while self.error is None:
                pkt = self._match_one()
                if pkt is None:
                    break
                try:
                    if callable(self.sink):
                        self.sink(pkt)
                    else:
                        self.sink.submit(pkt)
                        if self.process_each:
                            self.sink.process()
                except BaseException as e:     # noqa: BLE001 (kept and raised by drain/stop)
                    self.error = e
                finally:
                    with self._qlock:
                        self._inflight -= 1

    def _raise_error(self):
        if self.error is not None:
            self._reported = True
            raise RuntimeError(f"the ingest thread stopped on {type(self.error).__name__}: "
                               f"{self.error}") from self.error

    # ---------- lifecycle ----------

    def drain(self, timeout: float = 30.0, min_conns: int = 1) -> bool:
        """Block until every connected agent disconnected and all matchable
        pairs were fully ingested. Returns False on timeout; raises at once
        if the sink raised.

        A server that has never seen a connection is NOT drained: before any
        agent connects the queues are trivially empty, and returning True
        then would report success before the stream even started.
        `min_conns` is the number of agent connections that must have been
        observed (ever, not concurrently) before "drained" can be true —
        pass the expected agent count when known."""
        t0 = time.time()
        min_conns = max(1, int(min_conns))
        while time.time() - t0 < timeout:
            self._raise_error()
            with self._qlock:
                seen = self._conns_seen
                conns = self._open_conns
                busy = self._inflight
                pending = any(m and self._imgs.get(c) for c, m in self._msgs.items())
            if (seen >= min_conns and conns == 0 and busy == 0
                    and not pending and not self._ingest_wake.is_set()):
                # one settle pass for the ingest thread
                time.sleep(0.05)
                with self._qlock:
                    busy = self._inflight
                    pending = any(m and self._imgs.get(c) for c, m in self._msgs.items())
                if busy == 0 and not pending:
                    self._raise_error()
                    return True
            time.sleep(0.02)
        self._raise_error()
        return False

    def stop(self):
        self._stop = True
        self._ingest_wake.set()
        try:
            self._listener.close()
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        self._ingest_thread.join(timeout=2.0)
        if not self._reported:
            self._raise_error()
