"""The batched small symmetric eigensolver (`cuda_kernels.small_eigh`, the
8-point fundamental matrix's eigensolver on the card) on the CPU.

Its twin (cyclic Jacobi in plain PyTorch, the kernel's rotations in the
kernel's order) is held to torch.linalg.eigh: eigenvalues within EIG_TOL of
the largest, eigenvectors up to sign within VEC_TOL where the eigenvalues
are apart, orthonormal columns, ascending order. The rank-2 projection
that `ransac._eight_point` takes through FᵀF's eigenvectors is held to the
SVD's, and the 8-point F through the twin in float64 (what the card runs)
and through LAPACK in float32 (what the CPU runs) to F computed in float64
by LAPACK; the card's `essential_pose` against the JAX package's, a named
departure. The kernel against its twin, bit for bit, runs on the card
(`test_torch_cuda.py`, `chip_smoke.py`).
"""

import numpy as np
import pytest
import torch

from cvids_tpu_torch.ops import cuda_kernels as ck
from cvids_tpu_torch.ops import ransac

EIG_TOL = 1e-5      # eigenvalues, relative to the largest [measured 2.5e-6 at n = 12]
VEC_TOL = 1e-4      # 1 - |cos| between eigenvectors of eigenvalues 1 % apart or more


def _spd(rng, b, n):
    x = torch.from_numpy(rng.normal(size=(b, n, n)).astype(np.float32))
    return x @ x.transpose(-1, -2)


@pytest.mark.parametrize("n", [1, 3, 9, 12])
def test_twin_matches_linalg_eigh(n):
    rng = np.random.default_rng(n)
    a = _spd(rng, 32, n)
    w, v = ck.small_eigh(a)                    # a CPU tensor: the twin
    wr, vr = torch.linalg.eigh(a)
    scale = wr.abs().amax(-1, keepdim=True)
    assert float(((w - wr).abs() / scale).max()) < EIG_TOL
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    eye = torch.eye(n).expand(32, n, n)
    assert float((v.transpose(-1, -2) @ v - eye).abs().max()) < 1e-5
    cos = (v * vr).sum(-2).abs()
    gap = torch.full_like(w, float("inf"))
    if n > 1:
        d = (wr[:, 1:] - wr[:, :-1]) / scale
        gap[:, 1:] = d
        gap[:, :-1] = torch.minimum(gap[:, :-1], d)
    apart = gap > 1e-2
    assert float((1.0 - cos)[apart].max()) < VEC_TOL
    assert float((a @ v - v * w[:, None, :]).abs().amax((-1, -2)).div(scale[:, 0]).max()) < 1e-5


def test_twin_reads_the_lower_triangle_and_orders_ties():
    """The upper triangle is not read (as torch.linalg.eigh's default);
    equal eigenvalues keep their index order."""
    a = torch.diag(torch.tensor([3.0, 1.0, 1.0, 2.0]))[None].clone()
    a[0, 0, 3] = 100.0                            # upper: ignored
    w, v = ck.small_eigh(a)
    assert w.tolist() == [[1.0, 1.0, 2.0, 3.0]]
    assert torch.equal(v[0].abs(), torch.eye(4)[:, [1, 2, 3, 0]])


def test_rank2_projection_through_ftf_equals_svd():
    """F (I - v3 v3ᵀ), v3 FᵀF's eigenvector of the least eigenvalue, is the
    SVD's U diag(s1, s2, 0) Vᵀ."""
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.normal(size=(64, 3, 3)).astype(np.float32))
    _, vf = ck.small_eigh(f.transpose(-1, -2) @ f)
    v3 = vf[..., :, 0:1]
    f2 = f - (f @ v3) @ v3.transpose(-1, -2)
    u, s, vt = torch.linalg.svd(f)
    s = torch.stack([s[:, 0], s[:, 1], torch.zeros_like(s[:, 2])], -1)
    ref = (u * s[:, None, :]) @ vt
    assert float((f2 - ref).abs().max() / ref.abs().max()) < 1e-5


def test_eight_point_through_the_twin_is_as_close_to_float64():
    """The card's 8-point F (float64 systems through the Jacobi eigensolver,
    here its twin) and the CPU's (float32 through LAPACK, the JAX
    package's arithmetic) against F computed in float64 throughout by
    LAPACK, up to sign and scale, on noisy 8-point samples: the twin's
    median error within F_TOL [measured 3.4e-8], LAPACK's float32 [measured
    1.2e-3] a hundred times larger at least."""
    F_TOL = 1e-6
    rng = np.random.default_rng(5)
    pts = rng.uniform(-2, 2, (128, 8, 3)).astype(np.float32)
    pts[..., 2] += 6.0
    r = np.asarray([[0.995, -0.0998, 0.0], [0.0998, 0.995, 0.0], [0.0, 0.0, 1.0]], np.float32)
    pc2 = pts @ r.T + np.array([0.4, 0.1, 0.05], np.float32)
    p1 = pts[..., :2] / pts[..., 2:3] + rng.normal(size=(128, 8, 2)) * 1e-3
    p2 = pc2[..., :2] / pc2[..., 2:3] + rng.normal(size=(128, 8, 2)) * 1e-3
    p1, p2 = (torch.from_numpy(x.astype(np.float32)) for x in (p1, p2))

    def unit(f):
        return (f / f.flatten(1).norm(dim=1)[:, None, None]).double()

    ref = unit(ransac._eight_point(p1.double(), p2.double(), jacobi=False))
    err = {}
    for name, jacobi in (("lapack", False), ("twin", True)):
        f = unit(ransac._eight_point(p1, p2, jacobi=jacobi))
        err[name] = float(torch.minimum((f - ref).abs().amax((1, 2)),
                                        (f + ref).abs().amax((1, 2))).median())
    assert err["twin"] < F_TOL and 100 * err["twin"] < err["lapack"], err


@pytest.mark.parametrize("outliers", [0, 15])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_card_essential_pose_departs_from_jax_by_its_rounding(seed, outliers):
    """A named departure: the card's 8-point F (float64, Jacobi; here the
    twin) against the JAX package's (float32 LAPACK, which the CPU path
    keeps) through `essential_pose` on `test_torch_features.py`'s two-view
    cases with JAX's draws. The card's pose is held to the truth of these
    exact inliers within POSE_TOL [measured 1e-5], where the JAX package's
    is up to 9e-2 off; the inlier sets and the cheirality votes differ from
    the JAX package's by at most one point [measured: the inliers in one
    case of six, the votes in two, each by one]."""
    import functools

    import jax
    import jax.numpy as jnp
    from cvids_tpu.ops import ransac as jransac
    from test_torch_features import _two_views

    POSE_TOL = 1e-4
    rng = np.random.default_rng(seed)
    p0, p1, valid, r_true, t_true = _two_views(rng, outliers=outliers)
    key = jax.random.PRNGKey(seed)
    want = jransac.essential_pose(jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(valid), key)
    gumbel = torch.from_numpy(np.array(jax.random.gumbel(key, (128, len(p0)))))
    card = functools.partial(ransac._eight_point, jacobi=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ransac, "_eight_point", card)
        got = ransac.essential_pose(torch.from_numpy(p0), torch.from_numpy(p1),
                                    torch.from_numpy(valid), gumbel)
    assert bool(got.ok) and bool(want.ok)
    assert int((got.inliers.numpy() != np.asarray(want.inliers)).sum()) <= 1
    assert abs(int(got.num_pos) - int(want.num_pos)) <= 1
    np.testing.assert_allclose(got.r.numpy(), r_true, atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), t_true, atol=POSE_TOL)
