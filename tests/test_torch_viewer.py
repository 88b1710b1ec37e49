"""The port's viewers and plots (`utils/viewer.py`, `utils/visualization.py`
and the server's `export_viewer`, `live_viewer`, `save_loop_overlay`)
against the JAX package's, on the CPU.

A JAX pose graph and TSDF volume are carried into the port through the
shared checkpoint layout (`utils/checkpoint`) and
`interop.tsdf_volume_to_torch`; `collect_state` of the two packages on the
same state agree: the agents and loops exactly, the mesh within MESH_TOL.
test_extras.py's visualization, overlay and viewer cases run on the port
(matplotlib is installed here; on a machine without it every plot returns
False, as the JAX package's do).
"""

import base64
import dataclasses
import json
import os
import tempfile
import urllib.request
from html.parser import HTMLParser

import jax
import numpy as np
import pytest

from cvids_tpu.mapping import tsdf as jtsdf
from cvids_tpu.server import posegraph as jpg
from cvids_tpu.server import vocab as jvoc
from cvids_tpu.utils import checkpoint as jckpt
from cvids_tpu.utils import viewer as jviewer
from cvids_tpu_torch import interop
from cvids_tpu_torch.io import multiagent
from cvids_tpu_torch.io.synthetic import Trajectory
from cvids_tpu_torch.server import pipeline, posegraph, vocab
from cvids_tpu_torch.utils import checkpoint, viewer
from cvids_tpu_torch.utils import visualization as viz
from test_tsdf import H, K, W, look_at, render_sphere_depth

MESH_TOL = 1e-4      # m, mesh vertices from the same volume (marching tetrahedra in fp32)


def _decode(b64: str, width: int) -> np.ndarray:
    return np.frombuffer(base64.b64decode(b64), np.float32).reshape(-1, width)


def _stream(duration=6.0):
    """test_utils.py's one-agent server stream (numpy, from a seed)."""
    rng = np.random.default_rng(0)
    n_lm = 120
    landmarks = np.stack([rng.uniform(-10, 10, n_lm), rng.uniform(-10, 10, n_lm),
                          rng.uniform(0.2, 3, n_lm)], -1)
    descs = multiagent.landmark_descriptors(n_lm)
    packets, gt = multiagent.generate_packets(
        [multiagent.AgentSim(Trajectory.circle(radius=4.0, omega=0.5))], landmarks, descs,
        duration=duration, kf_rate=1.0, max_feats=30)
    return descs, packets, gt


def _cfg(mod):
    return mod.ServerConfig(kf_capacity=64, max_win=32, max_ext=64, max_loops=32,
                            optimize_every=10000)


@pytest.fixture(scope="module")
def carried():
    """A JAX pose graph and a JAX volume (two views of a sphere), and the
    port's copies of both."""
    descs, packets, _ = _stream()
    voc = jvoc.train_vocabulary(descs, k=5, levels=2, seed=0)
    sj = jpg.CollaborativePoseGraph(voc, _cfg(jpg))
    for _, _, _, pkt in packets:
        sj.add_keyframe(pkt)
    jv = jtsdf.TsdfVolume(jtsdf.TsdfConfig(voxel_size=0.08, capacity=1024, carving=False))
    center = np.array([0.0, 0.0, 1.0])
    for ang in (0.0, 0.6):
        eye = center + np.array([1.5 * np.cos(ang), 1.5 * np.sin(ang), 0.4])
        r_wc = look_at(eye, center)
        depth = np.nan_to_num(render_sphere_depth(center, 0.4, r_wc, eye), nan=0.0)
        jv.integrate(depth, np.full((H, W, 3), 128.0), K, r_wc.astype(np.float32),
                     eye.astype(np.float32))
    with tempfile.TemporaryDirectory() as tmp:
        jckpt.save_server(f"{tmp}/s.npz", sj)
        st = posegraph.CollaborativePoseGraph(
            interop.vocabulary_to_torch(jax.tree_util.tree_map(np.asarray, voc), "cpu"),
            _cfg(posegraph), device="cpu")
        checkpoint.load_server(f"{tmp}/s.npz", st)
    return sj, jv, st, interop.tsdf_volume_to_torch(jv, "cpu")


def test_collect_state_matches_jax(carried):
    sj, jv, st, tv = carried
    want = jviewer.collect_state(sj, volume=jv, rev=5)
    got = viewer.collect_state(st, volume=tv, rev=5)
    assert got["rev"] == 5 and got["agents"] == want["agents"] and got["loops"] == want["loops"]
    assert got["chunks"] == want["chunks"] and got["chunks"]["n"] > 0
    assert got["mesh"]["n"] == want["mesh"]["n"] > 0
    for f in ("pos", "col", "nrm"):
        np.testing.assert_allclose(_decode(got["mesh"][f], 9), _decode(want["mesh"][f], 9),
                                   atol=MESH_TOL, err_msg=f)
    vol_only = viewer.collect_volume_state(tv)
    assert vol_only["mesh"]["n"] == got["mesh"]["n"] and vol_only["chunks"] == got["chunks"]
    assert viewer.collect_volume_state(None) == {"mesh": {"n": 0, "pos": "", "col": "",
                                                          "nrm": ""},
                                                 "chunks": {"n": 0, "seg": "", "size": 0.0}}


def test_viewer_export_and_live(carried, tmp_path):
    """test_extras.py's viewer case on the port: exact positions and
    orthonormal rotations, a self-contained page whose state parses, the
    live server's page and state over HTTP."""
    _, _, st, tv = carried
    state = viewer.collect_state(st, rev=3)
    a = state["agents"][0]
    pos = _decode(a["pos"], 3)
    np.testing.assert_array_equal(pos, st.store.world_p[:st.store.count])
    rot = _decode(a["rot"], 9).reshape(-1, 3, 3)
    np.testing.assert_allclose(rot @ np.swapaxes(rot, 1, 2), np.tile(np.eye(3), (a["n"], 1, 1)),
                               atol=1e-5)
    p = str(tmp_path / "viewer.html")
    viewer.export_viewer_html(p, st, volume=tv, title="a </script> title")
    html = open(p).read()
    HTMLParser().feed(html)
    assert "</script> title" not in html and "webgl" in html
    page_state = json.loads(html.split("let STATE=", 1)[1].split("; const LIVE=", 1)[0])
    assert page_state == json.loads(json.dumps(viewer.collect_state(st, volume=tv)))
    lv = viewer.LiveViewer(lambda: viewer.collect_state(st, rev=7))
    try:
        got = json.loads(urllib.request.urlopen(lv.url + "state.json", timeout=10).read())
        assert got["rev"] == 7 and len(got["agents"]) == 1
        page = urllib.request.urlopen(lv.url, timeout=10).read().decode()
        assert "state.json" in page and "true" in page.split("LIVE=")[1][:6]
    finally:
        lv.close()


@pytest.fixture(scope="module")
def looped_server():
    """test_torch_pipeline.py's disturbance stream: one agent, 21 packets
    with tiny images, through the port's `CollaborativeServer` (no dense
    step), up to its first loops."""
    descs, packets, gt = _stream(duration=20.0)
    rng = np.random.default_rng(1)
    voc = vocab.train_vocabulary(descs, k=5, levels=2, seed=0, device="cpu")
    server = pipeline.CollaborativeServer(
        voc, pipeline.PipelineConfig(server=_cfg(posegraph), dense_enabled=False),
        device="cpu")
    for _, _, _, pkt in packets:
        server.submit(dataclasses.replace(pkt, image=rng.uniform(0, 255, (24, 32))))
        server.process()
    yield server, packets, gt
    server.close()


def test_server_viewer_methods(looped_server, tmp_path, monkeypatch):
    """`export_viewer` writes the page; `live_viewer` serves /state.json
    and, while the graph is unchanged, the cached body without collecting
    again; a new keyframe changes rev and the body."""
    server, packets, _ = looped_server
    assert server.graph.loop_count >= 1
    p = server.export_viewer(str(tmp_path / "v.html"))
    state = json.loads(open(p).read().split("let STATE=", 1)[1].split("; const LIVE=", 1)[0])
    assert state["agents"][0]["n"] == server.graph.store.count and state["loops"]["n"] >= 1
    collected = []
    real = viewer.collect_state
    monkeypatch.setattr(viewer, "collect_state",
                        lambda *a, **k: collected.append(1) or real(*a, **k))
    lv = server.live_viewer()
    try:
        def get():
            return urllib.request.urlopen(lv.url + "state.json", timeout=10).read()
        first, second = get(), get()
        assert first == second and len(collected) == 1
        server.submit(dataclasses.replace(packets[0][3], timestamp=99.0,
                                          image=np.zeros((24, 32))))
        server.process()
        third = get()
        assert len(collected) == 2 and json.loads(third)["rev"] != json.loads(first)["rev"]
    finally:
        lv.close()


def test_save_loop_overlay(looped_server, tmp_path):
    server, _, _ = looped_server
    assert server.graph.last_loop is not None and server._loop_overlay_pair is not None
    p = str(tmp_path / "loop.png")
    assert server.save_loop_overlay(p)
    assert os.path.getsize(p) > 1000


def test_visualization_outputs(looped_server, tmp_path, rng):
    """test_extras.py's plot and mosaic case on the port; the mesh preview
    takes a tensor."""
    import torch

    server, _, gt = looped_server
    p1 = str(tmp_path / "traj.png")
    assert viz.plot_trajectories(p1, server, gt)
    assert os.path.getsize(p1) > 1000
    p3 = str(tmp_path / "mosaic.png")
    assert viz.save_frame_mosaic(p3, [rng.uniform(0, 255, (24, 32)) for _ in range(3)])
    tris = torch.from_numpy(rng.uniform(0, 1, (50, 3, 3)).astype(np.float32))
    assert viz.plot_mesh_preview(str(tmp_path / "mesh.png"), tris)
    assert not viz.plot_mesh_preview(str(tmp_path / "none.png"), np.zeros((0, 3, 3)))


def test_loop_match_overlay(tmp_path, rng, monkeypatch):
    """test_extras.py's overlay case on the port, and every plot returns
    False where matplotlib is missing."""
    m = 20
    loop = {"i": 3, "j": 11, "uv_j": rng.uniform(-0.4, 0.4, (m, 2)).astype(np.float32),
            "uv_i": rng.uniform(-0.4, 0.4, (m, 2)).astype(np.float32),
            "inlier_mask": rng.uniform(size=m) > 0.4, "match_mask": np.ones(m, bool),
            "inliers": 12}
    img_new = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    img_old = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    p = str(tmp_path / "loop.png")
    assert viz.save_loop_match_overlay(p, img_new, img_old, loop)
    assert os.path.getsize(p) > 1000
    assert viz.save_loop_match_overlay(p, None, img_old, loop) is False
    monkeypatch.setattr(viz, "_mpl", lambda: None)
    q = str(tmp_path / "absent.png")
    assert viz.save_loop_match_overlay(q, img_new, img_old, loop) is False
    assert viz.save_frame_mosaic(q, [img_new]) is False
    assert not os.path.exists(q)
