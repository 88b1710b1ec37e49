"""Binary bag-of-words vocabulary for place recognition (port of
``cvids_tpu/server/vocab.py``).

Two vocabularies, as in the JAX package:

- `Vocabulary`: an implicit complete k-ary tree trained by hierarchical
  binary k-medoids (numpy), with dense (W,) BoW vectors and a database that
  scores all keyframes with one L1 pass (`BowDatabase`);
- `TreeVocabulary`: an explicit tree in the reference's DBoW2 binary format
  (`brief_k10L6.bin` scale, 10^6 words), with fixed-capacity sparse BoW
  vectors and a database that densifies only the query (`SparseBowDatabase`).

Scoring is DBoW2's normalized L1: s(v, w) = 1 - 0.5 * |v/|v| - w/|w||_1.
Descriptors on the device are (N, 8) int32 views of the uint32 words. Top-k
selections use a stable sort, so ties go to the lower index as `lax.top_k`
sends them.

A keyframe's query-and-insert is one fixed-shape program, as in the JAX
package (`_sparse_bow_query` + `_sparse_insert` + `_client_set`; dense:
`_bow_vector_impl` + `_db_topk_masked` + `_db_insert` + `_client_set`):
`_sparse_query_insert` and `_dense_query_insert`, replayed on the card as
one CUDA graph (`utils.cuda_graph.GraphedCall`) over the database's store
and tree, which are bound (updated in place; the tree is not copied in).
The row count, the query's client and the recent-frame cut enter as 0-d
device tensors, one pinned copy a keyframe, so the graph serves every
keyframe of a capacity tier; a growth moves the store, drops the tier's
graph and captures the next tier's at its first call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.cuda_kernels import popcount32
from ..ops.hamming import descriptors_to_torch

__all__ = ["Vocabulary", "train_vocabulary", "quantize", "bow_vector",
           "score_database", "BowDatabase", "TreeVocabulary",
           "load_dbow_binary", "save_dbow_binary", "tree_from_trained",
           "quantize_tree", "sparse_bow", "SparseBowDatabase",
           "synthesize_tree_vocabulary", "generic_vocabulary"]


_GENERIC_CACHE: dict = {}


def generic_vocabulary(k: int = 10, levels: int = 4, seed: int = 20240,
                       device=None) -> "TreeVocabulary":
    """A held-out generic BRIEF vocabulary, the `brief_k10L6.bin` posture
    (`collaborative_server_node.cpp:76-91`: the reference ships a pretrained
    vocabulary and never trains on the evaluation sequence).

    Descriptors come from 8 procedurally rendered worlds (2 views each)
    whose seeds are disjoint from every test world, through FAST and BRIEF
    on `device` (None: the card); the tree is trained on the host. The same
    worlds, draws and features as the JAX package's, so the two trees are
    equal. Deterministic and cached per (k, levels, seed)."""
    device = resolve_device(device)
    key = (k, levels, seed)
    if key in _GENERIC_CACHE:
        return _GENERIC_CACHE[key]
    from ..camera.pinhole import PinholeCamera
    from ..io import render
    from ..ops import brief, fast
    from ..ops.image import gaussian_blur

    rng = np.random.default_rng(seed)
    cam = PinholeCamera.create(220.0, 220.0, 160.0, 120.0, (0, 0, 0, 0), 320, 240,
                               device="cpu")
    descs = []
    for w in range(8):          # 8 disjoint landmark worlds, 2 views each
        n_lm = 400
        lms = np.stack([rng.uniform(-6, 6, n_lm), rng.uniform(-6, 6, n_lm),
                        rng.uniform(2.0, 9.0, n_lm)], -1)
        inten = rng.uniform(60, 180, n_lm)
        for _ in range(2):
            yaw = rng.uniform(-0.4, 0.4)
            r_wb = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                             [np.sin(yaw), np.cos(yaw), 0],
                             [0, 0, 1.0]])
            p_wb = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 0.0])
            img = render.render_blobs(cam, lms, inten, r_wb, p_wb, np.eye(3), np.zeros(3),
                                      idx_offset=10_000 * (w + 1))
            img_t = torch.from_numpy(img).to(device)
            blurred = gaussian_blur(img_t, 2.0, radius=4)
            kps = fast.select_keypoints(fast.fast_score_map(img_t, 12.0), max_num=256, cell=8)
            d = brief.compute_brief(blurred, kps.xy, pre_blurred=True)
            descs.append(d[kps.valid].cpu().numpy().view(np.uint32))
    all_desc = np.concatenate(descs)
    voc = train_vocabulary(all_desc[:6000], k=k, levels=levels, seed=seed, device=device)
    tree = tree_from_trained(voc)
    _GENERIC_CACHE[key] = tree
    return tree


def _top_k(s: torch.Tensor, k: int):
    """(values, indices) of the k largest entries, ties to the lower index."""
    idx = torch.sort(s, descending=True, stable=True).indices[:k]
    return s[idx], idx


def _hamming_words(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance over the last (8-word) axis of broadcast int32 words."""
    return popcount32(a ^ b).sum(-1)


class Vocabulary(NamedTuple):
    """Flattened complete hierarchical vocabulary: per level l a (k^(l+1), 8)
    int32 tensor of the candidate children's descriptors for each node path;
    child index arithmetic replaces pointers."""

    level_desc: tuple      # tuple of (k^(l+1), 8) int32 tensors, l = 0..L-1
    weights: torch.Tensor  # (W,) idf word weights
    k: int
    levels: int

    @property
    def num_words(self) -> int:
        return int(self.k ** self.levels)

    def to(self, device) -> "Vocabulary":
        return Vocabulary(tuple(d.to(device) for d in self.level_desc),
                          self.weights.to(device), self.k, self.levels)


def _hamming_np(a, b):
    """(N,8)x(M,8) uint32 -> (N,M) int popcount distances (numpy, train-time)."""
    x = a[:, None, :] ^ b[None, :, :]
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def _kmedoids_binary(desc: np.ndarray, k: int, rng, iters: int = 8) -> np.ndarray:
    """Binary k-means with bitwise-majority centroids (DBoW's scheme)."""
    n = desc.shape[0]
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = desc
        if n > 0:
            out[n:] = desc[rng.integers(0, n, k - n)]
        return out
    centers = desc[rng.choice(n, k, replace=False)]
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(1)
        bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # (N, 256)
        new_centers = []
        for c in range(k):
            sel = bits[assign == c]
            if len(sel) == 0:
                new_centers.append(centers[c])
                continue
            maj = (sel.mean(0) >= 0.5).astype(np.uint8)
            new_centers.append(np.packbits(maj).view(np.uint32))
        centers = np.stack(new_centers)
    return centers.astype(np.uint32)


def train_vocabulary(descriptors: np.ndarray, k: int = 10, levels: int = 3,
                     seed: int = 0, weighting: str = "idf",
                     device=None) -> Vocabulary:
    """Hierarchical binary k-means (numpy) of (N, 8) uint32 descriptors; the
    vocabulary's tensors are put on `device` (None: the card,
    `default_device()`, which raises where there is none; "cpu": the host)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    desc = np.asarray(descriptors, np.uint32)

    # level 0: k clusters of everything; level l: k clusters per leaf path
    groups = [desc]
    level_desc = []
    for l in range(levels):
        centers_l = np.zeros((k ** (l + 1), 8), np.uint32)
        next_groups = []
        for gi, g in enumerate(groups):
            centers = _kmedoids_binary(g, k, rng)
            centers_l[gi * k:(gi + 1) * k] = centers
            if l + 1 < levels:
                if len(g):
                    assign = _hamming_np(g, centers).argmin(1)
                else:
                    assign = np.zeros(0, int)
                for c in range(k):
                    next_groups.append(g[assign == c] if len(g) else g)
        level_desc.append(descriptors_to_torch(centers_l, device))
        groups = next_groups

    # idf weights from the training corpus
    w = torch.ones(k ** levels, dtype=torch.float32, device=device)
    voc = Vocabulary(tuple(level_desc), w, k, levels)
    if weighting == "idf" and len(desc):
        words = quantize(voc, descriptors_to_torch(desc, device)).cpu().numpy()
        counts = np.bincount(words, minlength=k ** levels).astype(np.float32)
        w_np = np.log(len(desc) / np.maximum(counts, 1.0)).astype(np.float32)
        voc = voc._replace(weights=torch.from_numpy(np.maximum(w_np, 1e-3)).to(device))
    return voc


def quantize(voc: Vocabulary, descriptors: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N,) int64 word ids: batched tree descent, the first
    closest child at each level."""
    n = descriptors.shape[0]
    dev = descriptors.device
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    kids = torch.arange(voc.k, device=dev)
    for l in range(voc.levels):
        cand = voc.level_desc[l][node[:, None] * voc.k + kids[None, :]]     # (N, k, 8)
        d = _hamming_words(descriptors[:, None, :], cand)                  # (N, k)
        node = node * voc.k + torch.argmin(d, dim=-1)
    return node


def bow_vector(voc: Vocabulary, descriptors: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """L1-normalized tf-idf BoW vector (W,) for one descriptor set. Word
    counts are exact; the L1 norm is a reduction, so the vector may differ
    from the JAX package's in the last ulp."""
    words = quantize(voc, descriptors)
    ones = torch.ones(descriptors.shape[0], dtype=torch.float32, device=descriptors.device)
    if valid is not None:
        ones = torch.where(valid, ones, torch.zeros((), device=ones.device))
    v = torch.zeros(voc.num_words, dtype=torch.float32, device=ones.device)
    v = v.index_add_(0, words, ones) * voc.weights
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-12)


def score_database(query: torch.Tensor, db: torch.Tensor,
                   db_valid: torch.Tensor | None = None) -> torch.Tensor:
    """DBoW2 L1 score of `query` (W,) against all rows of `db` (N, W)."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(query[None, :] - db), dim=-1)
    if db_valid is not None:
        s = torch.where(db_valid, s, torch.full((), -1.0, device=s.device))
    return s


def _exclude_mask(client_dev: torch.Tensor, count, query_client, recent_cut) -> torch.Tensor:
    """Query-validity mask (stored, and not a recent same-client frame),
    built on the device from scalars (ints, or 0-d device tensors)."""
    r = torch.arange(client_dev.shape[0], device=client_dev.device)
    return (r < count) & ~((client_dev == query_client) & (r >= recent_cut))


def _insert_row(client_dev: torch.Tensor, count: torch.Tensor, query_client: torch.Tensor,
                *rows: tuple[torch.Tensor, torch.Tensor]) -> None:
    """Write each (store, value) at row `count` and the client there, in
    place, at a tensor index (the JAX package's `.at[idx].set`)."""
    row = count.reshape(1)
    for store, value in rows:
        store.index_copy_(0, row, value[None].to(store.dtype))
    client_dev.index_copy_(0, row, query_client.reshape(1).to(client_dev.dtype))


def _dense_query_insert(vectors, client_dev, count, query_client, recent_cut, vec,
                        top_k: int):
    """One keyframe against the dense store: masked L1 scores, top-k, then
    `vec` and the client inserted at row `count` (`_db_topk_masked`,
    `_db_insert`, `_client_set`). Returns (indices, scores)."""
    valid = _exclude_mask(client_dev, count, query_client, recent_cut)
    s, idx = _top_k(score_database(vec, vectors, valid), top_k)
    _insert_row(client_dev, count, query_client, (vectors, vec))
    return idx, s


def _dense_bow_query_insert(voc, descriptors, valid, vectors, client_dev, count,
                            query_client, recent_cut, top_k: int):
    """`_dense_query_insert` of the descriptors' BoW vector
    (`_bow_vector_impl` first)."""
    return _dense_query_insert(vectors, client_dev, count, query_client, recent_cut,
                               bow_vector(voc, descriptors, valid), top_k)


class _Scalars:
    """A database's (row count, query client, recent cut) as 0-d views of
    one persistent int64 device buffer, filled by one copy a keyframe (from
    pinned memory on a card): a graph's bound inputs, the same storage at
    every call."""

    def __init__(self, device):
        self.buf = torch.zeros(3, dtype=torch.int64, device=device)

    def __call__(self, count: int, query_client: int, recent_cut: int):
        host = torch.tensor([count, query_client, recent_cut], dtype=torch.int64)
        if self.buf.is_cuda:
            host = host.pin_memory()
        self.buf.copy_(host, non_blocking=self.buf.is_cuda)
        return self.buf[0], self.buf[1], self.buf[2]


class BowDatabase:
    """Fixed-capacity database of dense BoW vectors (the reference's
    `BriefDatabase` role: add + query excluding recent frames,
    `server_pose_graph.cpp:971-1062`). The vector matrix lives on the
    vocabulary's device and is updated in place; `query_and_add` and
    `query_and_add_descriptors` are each one program (graphed on a card)."""

    def __init__(self, voc: Vocabulary, capacity: int = 4096):
        from ..utils.cuda_graph import GraphedCall

        self.voc = voc
        dev = voc.weights.device
        self.vectors = torch.zeros((capacity, voc.num_words), dtype=torch.float32, device=dev)
        self.client = np.full(capacity, -1, np.int32)
        self.client_dev = torch.full((capacity,), -1, dtype=torch.int32, device=dev)
        self.count = 0
        self._scalars = _Scalars(dev)
        self._query_insert = GraphedCall(_dense_query_insert, bound=(0, 1, 2, 3, 4))
        self._bow_query_insert = GraphedCall(_dense_bow_query_insert,
                                             bound=(0, 3, 4, 5, 6, 7))

    def _grow_if_full(self):
        if self.count >= len(self.client):
            # power-of-two growth, mirroring KeyframeStore._grow; the old
            # tier's graphs go with its store
            self.vectors = torch.cat([self.vectors, torch.zeros_like(self.vectors)])
            self.client = np.concatenate([self.client, np.full_like(self.client, -1)])
            self.client_dev = torch.cat([self.client_dev, torch.full_like(self.client_dev, -1)])
            self._query_insert.clear()
            self._bow_query_insert.clear()

    def add(self, vec: torch.Tensor, client_id: int) -> int:
        self._grow_if_full()
        idx = self.count
        self.vectors[idx] = vec
        self.client[idx] = client_id
        self.client_dev[idx:idx + 1].fill_(client_id)   # item assignment would sync
        self.count += 1
        return idx

    def _topk(self, vec: torch.Tensor, query_client: int, exclude_recent: int,
              top_k: int):
        valid = _exclude_mask(self.client_dev, self.count, query_client,
                              max(self.count - exclude_recent, 0))
        return _top_k(score_database(vec, self.vectors, valid), top_k)

    def query(self, vec: torch.Tensor, query_client: int,
              exclude_recent: int = 10, top_k: int = 4):
        """Scores against all stored frames; same-client frames within
        `exclude_recent` of the newest are masked (the reference's max_id
        argument). Returns numpy (indices, scores) of the top_k."""
        s, idx = self._topk(vec, query_client, exclude_recent, top_k)
        return idx.cpu().numpy(), s.cpu().numpy()

    def _scalars_for(self, client_id: int, exclude_recent: int):
        return self._scalars(self.count, client_id, max(self.count - exclude_recent, 0))

    def _inserted(self, client_id: int) -> None:
        self.client[self.count] = client_id
        self.count += 1

    def query_and_add(self, vec: torch.Tensor, client_id: int,
                      exclude_recent: int = 10, top_k: int = 4):
        """Query (excluding the frame being added), then insert, as one
        program. Returns DEVICE tensors (indices, scores): the ingest
        pipeline fetches them one keyframe later."""
        self._grow_if_full()
        idx, s = self._query_insert(self.vectors, self.client_dev,
                                    *self._scalars_for(client_id, exclude_recent), vec, top_k)
        self._inserted(client_id)
        return idx, s

    def query_and_add_descriptors(self, descriptors: torch.Tensor, client_id: int,
                                  exclude_recent: int = 10, top_k: int = 4,
                                  valid: torch.Tensor | None = None):
        """`query_and_add` of the descriptors' BoW vector, the vector
        computed inside the same program (the per-keyframe ingest step)."""
        self._grow_if_full()
        idx, s = self._bow_query_insert(self.voc, descriptors, valid, self.vectors,
                                        self.client_dev,
                                        *self._scalars_for(client_id, exclude_recent), top_k)
        self._inserted(client_id)
        return idx, s


# ---------------------------------------------------------------------------
# DBoW2-binary-compatible explicit-tree vocabulary + sparse BoW
# ---------------------------------------------------------------------------


class TreeVocabulary(NamedTuple):
    """Explicit-tree vocabulary (handles incomplete trees, unlike the
    implicit complete-tree `Vocabulary`); numpy arrays, as loaded."""

    children: np.ndarray    # (N_nodes, k) int32 node ids, -1 = missing
    node_desc: np.ndarray   # (N_nodes, 8) uint32
    word_id: np.ndarray     # (N_nodes,) int32, -1 for internal nodes
    weights: np.ndarray     # (num_words,) float32 idf word weights
    k: int
    levels: int
    num_words: int
    scoring_type: int = 0   # L1_NORM (DBoW2 enum), carried for re-export
    weighting_type: int = 0  # TF_IDF


_NODE_DT = np.dtype([("nodeId", "<i4"), ("parentId", "<i4"),
                     ("weight", "<f8"), ("desc", "<u8", (4,))])
_WORD_DT = np.dtype([("nodeId", "<i4"), ("wordId", "<i4")])


def load_dbow_binary(path: str) -> TreeVocabulary:
    """Parse the VINS/DBoW2 binary vocabulary format (header 6×int32, then
    nNodes × {int32 nodeId, int32 parentId, float64 weight, uint64 desc[4]},
    then nWords × {int32 nodeId, int32 wordId})."""
    with open(path, "rb") as f:
        head = np.fromfile(f, np.int32, 6)
        k, levels, scoring, weighting, n_nodes, n_words = (int(x) for x in head)
        nodes = np.fromfile(f, _NODE_DT, n_nodes)
        words = np.fromfile(f, _WORD_DT, n_words)

    total = n_nodes + 1  # +1: the root is implicit (id 0), as in the reference
    children = np.full((total, k), -1, np.int32)
    node_desc = np.zeros((total, 8), np.uint32)
    node_weight = np.zeros(total, np.float64)
    nid = nodes["nodeId"]
    pid = nodes["parentId"]
    node_desc[nid] = nodes["desc"].view(np.uint32).reshape(-1, 8)
    node_weight[nid] = nodes["weight"]
    # children in file order (the reference push_backs in this order, which
    # fixes the tie-breaking order of the descent): a stable group-by-parent
    # cumcount
    order = np.argsort(pid, kind="stable")
    ps = pid[order]
    first = np.concatenate([[True], ps[1:] != ps[:-1]]) if n_nodes else \
        np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(first, np.arange(n_nodes), 0))
    slot = np.arange(n_nodes) - start
    children[ps, slot] = nid[order]

    word_id = np.full(total, -1, np.int32)
    word_id[words["nodeId"]] = words["wordId"]
    weights = np.zeros(n_words, np.float32)
    weights[word_id[words["nodeId"]]] = node_weight[words["nodeId"]].astype(np.float32)
    return TreeVocabulary(children, node_desc, word_id, weights, k, levels,
                          n_words, scoring, weighting)


def save_dbow_binary(path: str, tree: TreeVocabulary) -> None:
    """Write a TreeVocabulary in the reference's binary format (nodes in BFS
    order, the root implicit); round-trips through `load_dbow_binary`."""
    total = tree.children.shape[0]
    parent_of = np.zeros(total, np.int32)
    ch = tree.children
    valid_ch = ch >= 0
    parent_of[ch[valid_ch]] = np.repeat(np.arange(total), ch.shape[1])[
        valid_ch.ravel()]
    order = []
    frontier = np.asarray([0], np.int64)
    while len(frontier):
        kids = ch[frontier].ravel()
        kids = kids[kids >= 0]
        order.append(kids)
        frontier = kids
    order = np.concatenate(order) if order else np.zeros(0, np.int64)
    nodes = np.zeros(len(order), _NODE_DT)
    nodes["nodeId"] = order
    nodes["parentId"] = parent_of[order]
    w_of = tree.word_id[order]
    nodes["weight"] = np.where(
        w_of >= 0, tree.weights[np.maximum(w_of, 0)].astype(np.float64), 0.0)
    nodes["desc"] = np.ascontiguousarray(
        tree.node_desc[order]).view(np.uint64).reshape(-1, 4)
    word_nodes = np.nonzero(tree.word_id >= 0)[0]
    words = np.zeros(len(word_nodes), _WORD_DT)
    words["nodeId"] = word_nodes.astype(np.int32)
    words["wordId"] = tree.word_id[word_nodes]
    with open(path, "wb") as f:
        np.asarray([tree.k, tree.levels, tree.scoring_type,
                    tree.weighting_type, len(order), len(word_nodes)],
                   np.int32).tofile(f)
        nodes.tofile(f)
        words.tofile(f)


def tree_from_trained(voc: Vocabulary) -> TreeVocabulary:
    """Convert the implicit complete-tree `Vocabulary` into the explicit
    form (e.g. to export via `save_dbow_binary`)."""
    k, levels = voc.k, voc.levels
    counts = [k ** (l + 1) for l in range(levels)]
    offsets = np.concatenate([[1], 1 + np.cumsum(counts)])  # node id ranges
    total = int(offsets[-1])
    children = np.full((total, k), -1, np.int32)
    node_desc = np.zeros((total, 8), np.uint32)
    word_id = np.full(total, -1, np.int32)
    for l in range(levels):
        base = offsets[l]
        n_l = counts[l]
        node_desc[base:base + n_l] = voc.level_desc[l].cpu().numpy().view(np.uint32)
        if l == 0:
            children[0, :] = np.arange(1, 1 + k)
        else:
            pbase = offsets[l - 1]
            for p in range(counts[l - 1]):
                children[pbase + p] = base + p * k + np.arange(k)
    leaf_base = offsets[levels - 1]
    word_id[leaf_base:leaf_base + counts[-1]] = np.arange(counts[-1])
    return TreeVocabulary(children, node_desc, word_id,
                          voc.weights.cpu().numpy().astype(np.float32), k, levels,
                          int(counts[-1]))


def _tree_tensors(tree: TreeVocabulary, device):
    """(children, node_desc as int32 words, word_id, weights) on `device`."""
    return (torch.from_numpy(np.ascontiguousarray(tree.children)).to(device),
            descriptors_to_torch(tree.node_desc, device),
            torch.from_numpy(np.ascontiguousarray(tree.word_id)).to(device),
            torch.from_numpy(np.ascontiguousarray(tree.weights, np.float32)).to(device))


def _quantize_tree(children, node_desc, word_id, descriptors, levels: int):
    n = descriptors.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=descriptors.device)
    for _ in range(levels):
        ch = children[node]                                        # (N, k)
        cd = node_desc[torch.clamp(ch, min=0)]                     # (N, k, 8)
        d = _hamming_words(descriptors[:, None, :], cd)
        d = torch.where(ch >= 0, d, torch.full((), 1 << 20, device=d.device))
        nxt = torch.gather(ch, 1, torch.argmin(d, dim=-1, keepdim=True))[:, 0]
        node = torch.where(nxt >= 0, nxt.to(torch.int64), node)  # early leaf: stay
    return word_id[node]


def quantize_tree(tree: TreeVocabulary, descriptors: torch.Tensor) -> torch.Tensor:
    """(N, 8) int32 -> (N,) word ids via explicit-tree descent (the tree is
    moved to the descriptors' device on each call)."""
    children, node_desc, word_id, _ = _tree_tensors(tree, descriptors.device)
    return _quantize_tree(children, node_desc, word_id, descriptors, tree.levels)


def sparse_bow(tree: TreeVocabulary, descriptors: torch.Tensor,
               valid: torch.Tensor | None = None,
               capacity: int = 256) -> tuple[np.ndarray, np.ndarray]:
    """L1-normalized tf-idf BoW as fixed-capacity sparse (ids, values),
    merged on the host: word ids (capacity,) int32 with -1 padding, values
    (capacity,) float32."""
    words = quantize_tree(tree, descriptors).cpu().numpy()
    if valid is not None:
        words = words[valid.cpu().numpy()]
    words = words[words >= 0]
    uniq, cnt = np.unique(words, return_counts=True)
    vals = cnt.astype(np.float32) * tree.weights[uniq]
    norm = np.abs(vals).sum()
    if norm > 0:
        vals = vals / norm
    ids = np.full(capacity, -1, np.int32)
    out = np.zeros(capacity, np.float32)
    m = min(capacity, len(uniq))
    keep = np.argsort(-vals)[:m]   # keep the strongest words if over capacity
    ids[:m] = uniq[keep]
    out[:m] = vals[keep]
    return ids, out


def _sparse_scores(q_dense, db_ids, db_vals, db_valid):
    """L1 score = sum over common words of (|v| + |w| - |v - w|) / 2."""
    q_at = q_dense[torch.clamp(db_ids, min=0)]                   # (N, F)
    contrib = 0.5 * (torch.abs(q_at) + torch.abs(db_vals) - torch.abs(q_at - db_vals))
    zero = torch.zeros((), device=contrib.device)
    s = torch.sum(torch.where(db_ids >= 0, contrib, zero), dim=-1)
    return torch.where(db_valid, s, torch.full((), -1.0, device=s.device))


def _densify(q_ids, q_vals, num_words: int):
    """The query's (W,) dense vector (ids are unique; -1 pads add 0.0)."""
    q = torch.zeros(num_words, dtype=torch.float32, device=q_ids.device)
    zero = torch.zeros((), device=q_vals.device)
    return q.index_add_(0, torch.clamp(q_ids, min=0).to(torch.int64),
                        torch.where(q_ids >= 0, q_vals, zero))


def _sparse_bow_dev(tree_t, levels: int, desc, valid, f: int):
    """Sparse BoW on the device: tree descent + duplicate-word merge +
    tf-idf + L1 normalize + top-f truncation (ties to the lower word id)."""
    children, node_desc, word_id, weights = tree_t
    words = _quantize_tree(children, node_desc, word_id, desc, levels).to(torch.int64)
    if valid is not None:
        words = torch.where(valid, words, torch.full((), -1, device=words.device))
    n = max(words.shape[0], f)
    words = torch.cat([words, torch.full((n - words.shape[0],), -1,
                                         dtype=torch.int64, device=words.device)])
    w = torch.sort(words).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=w.device), w[1:] != w[:-1]])
    gid = torch.cumsum(first, 0) - 1                 # group index per element
    live = w >= 0
    counts = torch.zeros(n, dtype=torch.float32, device=w.device).index_add_(
        0, gid, live.to(torch.float32))
    uniq = torch.full((n,), -1, dtype=torch.int64, device=w.device).scatter_reduce_(
        0, gid, torch.where(live, w, torch.full((), -1, device=w.device)), reduce="amax")
    vals = counts * weights[torch.clamp(uniq, min=0)] * (uniq >= 0)
    norm = torch.sum(torch.abs(vals))
    vals = torch.where(norm > 0, vals / norm, vals)
    top_vals, top_idx = _top_k(vals, f)
    keep = top_vals > 0
    ids = torch.where(keep, uniq[top_idx], torch.full((), -1, device=w.device))
    return ids.to(torch.int32), torch.where(keep, top_vals, torch.zeros((), device=w.device))


def _sparse_query_insert(tree_t, desc, valid, ids, vals, client_dev, count, query_client,
                         recent_cut, levels: int, f: int, num_words: int, top_k: int):
    """One keyframe's ingest step against the sparse store: tree descent,
    sparse tf-idf, masked L1 score and top-k (`_sparse_bow_query`), then the
    query's (ids, vals) and client inserted at row `count`
    (`_sparse_insert`, `_client_set`). Returns (indices, scores)."""
    q_ids, q_vals = _sparse_bow_dev(tree_t, levels, desc, valid, f)
    db_valid = _exclude_mask(client_dev, count, query_client, recent_cut)
    s, order = _top_k(_sparse_scores(_densify(q_ids, q_vals, num_words), ids, vals,
                                     db_valid), top_k)
    _insert_row(client_dev, count, query_client, (ids, q_ids), (vals, q_vals))
    return order, s


class SparseBowDatabase:
    """Fixed-capacity sparse-BoW keyframe database for large vocabularies
    (the reference's inverted-index `BriefDatabase` at k=10 L=6 scale,
    `TemplatedDatabase.h:607-728`). A query densifies only the query vector
    and gathers it at the stored entries' word ids.

    The tree and the (N, F) id/value stores live on `device`: per keyframe
    only the descriptors and their validity mask cross to it (at 10^6 words
    the tree is ~80 MB)."""

    def __init__(self, tree: TreeVocabulary, capacity: int = 4096,
                 words_per_frame: int = 256, device=None):
        """`device=None` is the card (`default_device()`, which raises
        where there is none); pass "cpu" to run on the host."""
        from ..utils.cuda_graph import GraphedCall

        device = resolve_device(device)
        self.tree = tree
        self.f = words_per_frame
        self.ids = torch.full((capacity, words_per_frame), -1, dtype=torch.int32, device=device)
        self.vals = torch.zeros((capacity, words_per_frame), dtype=torch.float32, device=device)
        self.client = np.full(capacity, -1, np.int32)
        self.client_dev = torch.full((capacity,), -1, dtype=torch.int32, device=device)
        self.count = 0
        self._dev = _tree_tensors(tree, device)
        self._scalars = _Scalars(device)
        # the tree, the store and the scalars bound: only the descriptors
        # and their mask are copied in
        self._query_insert = GraphedCall(_sparse_query_insert, bound=(0, 3, 4, 5, 6, 7, 8))

    def _bow(self, descriptors, valid):
        return _sparse_bow_dev(self._dev, self.tree.levels, descriptors, valid, self.f)

    def _grow_if_full(self):
        if self.count >= len(self.client):
            # power-of-two growth, mirroring KeyframeStore._grow; the old
            # tier's graph goes with its store
            self.ids = torch.cat([self.ids, torch.full_like(self.ids, -1)])
            self.vals = torch.cat([self.vals, torch.zeros_like(self.vals)])
            self.client = np.concatenate([self.client, np.full_like(self.client, -1)])
            self.client_dev = torch.cat([self.client_dev, torch.full_like(self.client_dev, -1)])
            self._query_insert.clear()

    def _insert(self, ids, vals, client_id: int) -> int:
        idx = self.count
        self.ids[idx] = ids
        self.vals[idx] = vals
        self.client[idx] = client_id
        self.client_dev[idx:idx + 1].fill_(client_id)   # item assignment would sync
        self.count += 1
        return idx

    def add_descriptors(self, descriptors: torch.Tensor, client_id: int,
                        valid: torch.Tensor | None = None) -> int:
        self._grow_if_full()
        ids, vals = self._bow(descriptors, valid)
        return self._insert(ids, vals, client_id)

    def _topk(self, q_ids, q_vals, query_client, exclude_recent, top_k):
        db_valid = _exclude_mask(self.client_dev, self.count, query_client,
                                 max(self.count - exclude_recent, 0))
        s = _sparse_scores(_densify(q_ids, q_vals, self.tree.num_words),
                           self.ids, self.vals, db_valid)
        return _top_k(s, top_k)

    def query(self, descriptors: torch.Tensor, query_client: int,
              exclude_recent: int = 10, top_k: int = 4,
              valid: torch.Tensor | None = None):
        """Numpy (indices, scores) of the top_k stored frames."""
        q_ids, q_vals = self._bow(descriptors, valid)
        s, order = self._topk(q_ids, q_vals, query_client, exclude_recent, top_k)
        return order.cpu().numpy(), s.cpu().numpy()

    def query_and_add(self, descriptors: torch.Tensor, client_id: int,
                      exclude_recent: int = 10, top_k: int = 4,
                      valid: torch.Tensor | None = None):
        """Per-keyframe ingest step: query (excluding the frame being added),
        then insert, with one tree descent, as one program
        (`_sparse_query_insert`). Returns DEVICE tensors (indices, scores):
        the ingest pipeline fetches them one keyframe later."""
        self._grow_if_full()
        scalars = self._scalars(self.count, client_id, max(self.count - exclude_recent, 0))
        order, s = self._query_insert(self._dev, descriptors, valid, self.ids, self.vals,
                                      self.client_dev, *scalars, self.tree.levels, self.f,
                                      self.tree.num_words, top_k)
        self.client[self.count] = client_id
        self.count += 1
        return order, s


def synthesize_tree_vocabulary(k: int = 10, levels: int = 5,
                               seed: int = 0) -> TreeVocabulary:
    """Reference-scale vocabulary without a training corpus: a complete
    k-ary tree of `levels` levels (k=10, L=6 is the reference's 10^6-word
    `brief_k10L6.bin` scale) with i.i.d. random node descriptors (BRIEF bits
    are ~Bernoulli(0.5)) and uniform weights."""
    rng = np.random.default_rng(seed)
    counts = [k ** (l + 1) for l in range(levels)]
    offsets = np.concatenate([[1], 1 + np.cumsum(counts)])
    total = int(offsets[-1])
    children = np.full((total, k), -1, np.int32)
    node_desc = rng.integers(0, 2 ** 32, (total, 8), dtype=np.uint32)
    word_id = np.full(total, -1, np.int32)
    children[0, :] = np.arange(1, 1 + k)
    for l in range(1, levels):
        pbase, base = offsets[l - 1], offsets[l]
        n_par = counts[l - 1]
        children[pbase:pbase + n_par] = (
            base + np.arange(n_par)[:, None] * k + np.arange(k)[None, :])
    leaf_base = offsets[levels - 1]
    word_id[leaf_base:leaf_base + counts[-1]] = np.arange(counts[-1])
    n_words = int(counts[-1])
    weights = np.full(n_words, 1.0, np.float32)
    return TreeVocabulary(children, node_desc, word_id, weights, k, levels,
                          n_words)
