"""The port's native host library (`cvids_tpu_torch/native`: the max clique
and the inverted-index BoW database) against test_native.py's cases and the
JAX package's index, on the CPU.

The libraries are built here, at run time, by a fixture: with a C++
compiler on PATH a failed build fails these tests; only without one do they
skip, and say so. (test_native.py decides its skip when it is collected,
before any xdist worker may have built the JAX package's library.)
"""

import shutil

import numpy as np
import pytest

from cvids_tpu_torch import _build, native


@pytest.fixture(scope="module")
def built():
    if not (shutil.which("g++") or shutil.which("c++")):
        pytest.skip("no C++ compiler (g++ or c++) on PATH to build the native library")
    _build.build_host(native._SRC)        # raises RuntimeError when the build fails
    _build.build_host(native._BOW_SRC)
    native._TRIED = False
    assert native.available()
    return native


def test_native_max_clique_matches_known(built):
    a = np.zeros((8, 8), np.uint8)
    for i, j in [(0, 1), (1, 2), (0, 2), (2, 3), (4, 5), (5, 6), (4, 6), (6, 7), (4, 7), (5, 7)]:
        a[i, j] = a[j, i] = 1
    assert sorted(built.max_clique_native(a)) == [4, 5, 6, 7]


def test_native_max_clique_dense_and_empty(built):
    assert len(built.max_clique_native(np.ones((25, 25), np.uint8))) == 25
    assert len(built.max_clique_native(np.zeros((5, 5), np.uint8))) == 1
    assert len(built.max_clique_native(np.zeros((0, 0), np.uint8))) == 0


def test_native_heuristic_large_random(built, rng):
    n = 60
    a = (rng.random((n, n)) < 0.3)
    a = (a | a.T).astype(np.uint8)
    np.fill_diagonal(a, 0)
    planted = rng.choice(n, 12, replace=False)
    for i in planted:
        for j in planted:
            if i != j:
                a[i, j] = 1
    assert len(built.max_clique_native(a)) >= 12


def test_pcm_uses_native(built):
    from cvids_tpu_torch.server import pcm

    a = np.zeros((10, 10), bool)
    a[:6, :6] = True
    assert sorted(pcm.max_clique(a)) == [0, 1, 2, 3, 4, 5]


def _bow_vectors(rng, w=200, n=30, nnz=12):
    vecs = []
    for _ in range(n):
        v = np.zeros(w, np.float32)
        v[rng.choice(w, nnz, replace=False)] = rng.random(nnz).astype(np.float32)
        vecs.append(v / v.sum())
    return vecs


def test_native_bow_index_matches_dense(built, rng):
    """test_native.py's case: the index's scores are the dense sum(min)
    scorer's; the exclusion threshold zeroes the later entries."""
    vecs = _bow_vectors(rng)
    idx = built.NativeBowIndex(200)
    for i, v in enumerate(vecs):
        assert idx.add(v, client_id=i % 3) == i
    assert idx.count == len(vecs)
    q = vecs[7]
    scores = idx.query(q)
    ref = np.array([np.minimum(q, d).sum() for d in vecs], np.float32)
    np.testing.assert_allclose(scores, ref, atol=1e-6)
    assert np.argmax(scores) == 7
    assert (idx.query(q, exclude_from=7)[7:] == 0).all()
    assert built.NativeBowIndex(200).query(q).shape == (0,)


def test_native_bow_index_matches_jax(built, rng):
    """The port's index and the JAX package's (built by its own Makefile)
    return the same scores, bit for bit, on the same entries and queries."""
    import time

    from cvids_tpu import native as jnative

    # its library is made by `make` at first use, maybe by another worker at
    # this moment: look again for a few seconds before calling it missing
    for _ in range(20):
        if jnative.available():
            break
        jnative._TRIED = False
        time.sleep(0.5)
    assert jnative.available(), "the JAX package's native library did not build"
    vecs = _bow_vectors(rng, w=500, n=40, nnz=20)
    a, b = built.NativeBowIndex(500), jnative.NativeBowIndex(500)
    for i, v in enumerate(vecs):
        assert a.add(v, i % 4) == b.add(v, i % 4)
    for qi, ex in ((0, -1), (11, -1), (25, 20), (39, 5)):
        np.testing.assert_array_equal(a.query(vecs[qi], ex), b.query(vecs[qi], ex))
