"""Headless visualization — the ServerPlotter / rviz-marker equivalent
(port of ``cvids_tpu/utils/visualization.py``).

The reference renders a live Pangolin window with per-client trajectories,
camera frusta, loop-closure edges and a frame mosaic
(`server_pose_graph/include/server_plotter.h:286-691`) plus rviz markers
(`utility/server_visualization.cpp`). A server without a display renders the
same content headlessly to PNG via matplotlib when it is installed; without
it every function returns False, as the JAX package's do. Host numpy: the
port's server keeps its pose graph on the host, and an image or vertex
array given as a tensor is moved to the host at the call.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["plot_trajectories", "plot_mesh_preview", "save_frame_mosaic",
           "save_loop_match_overlay"]

_CLIENT_COLORS = ["tab:blue", "tab:orange", "tab:green", "tab:red",
                  "tab:purple", "tab:brown", "tab:pink", "tab:gray",
                  "tab:olive", "tab:cyan"]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except ImportError:
        return None


def plot_trajectories(path: str, server, gt: dict | None = None) -> bool:
    """Top-down (x, y) per-client trajectories + loop edges.

    server: CollaborativePoseGraph (or pipeline.CollaborativeServer.graph).
    gt: optional {(client, local_index): (p, q)} ground truth overlay.
    """
    plt = _mpl()
    if plt is None:
        return False
    g = getattr(server, "graph", server)
    st = g.store
    n = st.count
    fig, ax = plt.subplots(figsize=(7, 7))
    for cid in range(10):
        sel = np.nonzero(st.client[:n] == cid)[0]
        if len(sel) == 0:
            continue
        c = _CLIENT_COLORS[cid % len(_CLIENT_COLORS)]
        ax.plot(st.world_p[sel, 0], st.world_p[sel, 1], "-", color=c,
                label=f"agent {cid}", lw=1.5)
        if gt is not None:
            pts = np.asarray([gt[(cid, int(st.local_index[k]))][0] for k in sel
                              if (cid, int(st.local_index[k])) in gt])
            if len(pts):
                ax.plot(pts[:, 0], pts[:, 1], "--", color=c, alpha=0.4, lw=1.0)
    for e in range(g.loop_count):
        if not (g.loop_valid[e] and g.loop_pcm_ok[e]):
            continue
        i, j = g.loop_i[e], g.loop_j[e]
        ax.plot([st.world_p[i, 0], st.world_p[j, 0]],
                [st.world_p[i, 1], st.world_p[j, 1]], "-", color="k",
                alpha=0.25, lw=0.6)
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(f"{n} keyframes, {int(g.loop_valid.sum())} loops "
                 f"({int((g.loop_valid & g.loop_pcm_ok).sum())} after PCM)")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def plot_mesh_preview(path: str, verts: np.ndarray, max_tris: int = 20000) -> bool:
    """Quick 3-D scatter of triangle centroids colored by height."""
    plt = _mpl()
    if plt is None or len(verts) == 0:
        return False
    cent = _host(verts).mean(axis=1)
    if len(cent) > max_tris:
        cent = cent[np.random.default_rng(0).choice(len(cent), max_tris,
                                                    replace=False)]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(cent[:, 0], cent[:, 1], cent[:, 2], s=0.3, c=cent[:, 2],
               cmap="viridis")
    ax.set_title(f"{len(verts)} triangles")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def save_loop_match_overlay(path: str, img_new, img_old, loop: dict,
                            k_new: np.ndarray | None = None,
                            k_old: np.ndarray | None = None) -> bool:
    """Side-by-side render of an accepted loop closure with match lines —
    the reference plotter's loop-match image (`server_plotter.h:612-691`:
    hconcat of the two keyframes, inlier matches drawn across).

    loop: `CollaborativePoseGraph.last_loop` (uv_j/uv_i are normalized
    camera coordinates; pass the intrinsics `k_new`/`k_old` to place them on
    the images — defaults to a centered pinhole with f = 0.9 * width).
    Green lines: PnP inliers; red dots: matches rejected by the cascade.
    """
    plt = _mpl()
    if plt is None or img_new is None or img_old is None or loop is None:
        return False

    def to_px(uv, img, k):
        uv = np.asarray(uv, np.float64)
        h, w = img.shape[:2]
        if k is None:
            f = 0.9 * w
            k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
        return uv * [k[0, 0], k[1, 1]] + [k[0, 2], k[1, 2]]

    img_new = _host(img_new)
    img_old = _host(img_old)
    px_n = to_px(loop["uv_j"], img_new, k_new)
    px_o = to_px(loop["uv_i"], img_old, k_old)
    h = max(img_new.shape[0], img_old.shape[0])
    w0 = img_new.shape[1]
    canvas = np.zeros((h, w0 + img_old.shape[1]), np.float32)
    canvas[:img_new.shape[0], :w0] = img_new
    canvas[:img_old.shape[0], w0:] = img_old
    inl = np.asarray(loop["inlier_mask"], bool)
    cand = np.asarray(loop.get("match_mask", np.ones_like(inl)), bool)
    # only draw matches whose endpoints land inside both frames
    inside = ((px_n[:, 0] >= 0) & (px_n[:, 0] < img_new.shape[1])
              & (px_n[:, 1] >= 0) & (px_n[:, 1] < img_new.shape[0])
              & (px_o[:, 0] >= 0) & (px_o[:, 0] < img_old.shape[1])
              & (px_o[:, 1] >= 0) & (px_o[:, 1] < img_old.shape[0]))
    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(canvas, cmap="gray")
    for sel, color, lw in ((cand & ~inl & inside, "tab:red", 0.0),
                           (inl & inside, "lime", 0.7)):
        for a, b in zip(px_n[sel], px_o[sel]):
            if lw > 0:
                ax.plot([a[0], b[0] + w0], [a[1], b[1]], "-", color=color,
                        lw=lw, alpha=0.8)
            ax.plot([a[0]], [a[1]], ".", color=color, ms=2.5)
            ax.plot([b[0] + w0], [b[1]], ".", color=color, ms=2.5)
    ax.set_xlim(-0.5, canvas.shape[1] - 0.5)
    ax.set_ylim(canvas.shape[0] - 0.5, -0.5)
    ax.set_title(f"loop {loop['j']} -> {loop['i']}: "
                 f"{int(inl.sum())} inliers", fontsize=9)
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return True


def save_frame_mosaic(path: str, images: list, cols: int = 2) -> bool:
    """2xN tile of current agent frames (the reference's 2x2 mosaic)."""
    plt = _mpl()
    if plt is None or not images:
        return False
    rows = -(-len(images) // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for k, img in enumerate(images):
        ax = axes[k // cols][k % cols]
        ax.imshow(_host(img), cmap="gray")
        ax.set_title(f"agent {k}", fontsize=8)
        ax.axis("off")
    for k in range(len(images), rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return True
