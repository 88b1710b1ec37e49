"""The window solve of ``csrc/window_lm.cu`` stated in PyTorch, operation
for operation: `cuda_kernels.window_lm_twin`.

The contract is `vio.window_ba.solve_window_fast` (float32, a camera-only
prior or none): Levenberg-Marquardt over the window's camera states with the
landmarks eliminated exactly by their 3x3 blocks. The kernel runs the whole
solve in one block of 1024 threads; this module states every sum in the
kernel's order, so that the two agree bit for bit on the card:

- the camera-only factors (IMU, gauge anchors, bias priors, prior) are
  differentiated by forward-mode dual numbers (`Dual`: a value and its
  tangents over seed columns, with one stated rule an operation); the prior's
  Jacobian is its j times the derivative D of `cam_local_diff`, which is the
  identity but on the rotation blocks, so its Gram matrix is Dᵀ (jᵀj) D with
  jᵀj formed once a solve;
- the reprojection blocks are the closed form of `reprojection_jacobians`;
  a landmark's 3x3 block is inverted by its adjugate;
- a sum over landmarks runs in index order from +0, a sum over keyframes in
  slot order, a dot product of fixed length from its first product; the
  kernel skips the terms whose observation is not valid, which are ±0 here
  (adding ±0 to an accumulator that started at +0 changes nothing);
- the reduced camera system's lower triangle is factored by a right-looking
  Cholesky with the right-hand side as an extra row (the forward
  substitution), then solved back; a pivot that is not positive gives a NaN
  step, which the cost test rejects;
- a block-wide sum (`block_sum`) adds element i into lane i mod 1024 in
  index order, then halves over the 32 lanes of each warp and over the 32
  warps (the kernel's shuffles).

Every division is by a tensor (PyTorch's CUDA division by a Python scalar
multiplies by its reciprocal), every constant a float32 rounding of the
double the reference writes, and no operation fuses a multiply and an add.
"""

from __future__ import annotations

import math

import torch

BLOCK = 1024    # the kernel's threads, the lanes of `block_sum`
WARP = 32
PI = math.pi


# ---------------------------------------------------------------------------
# Dual numbers and the scalar functions, on components
# ---------------------------------------------------------------------------


def _col(x):
    return x[..., None] if isinstance(x, torch.Tensor) else x


class Dual:
    """A value `v` and its tangents `d` (v's shape plus one axis of seed
    columns). A tensor or float operand is a constant without tangent. The
    rules are the kernel's (``struct Dual``): (a b)' = a' b + a b',
    (a / b)' = (a' - (a / b) b') / b, (c / b)' = -((c / b) b') / b."""

    __slots__ = ("v", "d")

    def __init__(self, v, d):
        self.v, self.d = v, d

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v + o.v, self.d + o.d)
        return Dual(self.v + o, self.d)

    def __radd__(self, o):
        return Dual(o + self.v, self.d)

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v - o.v, self.d - o.d)
        return Dual(self.v - o, self.d)

    def __rsub__(self, o):
        return Dual(o - self.v, -self.d)

    def __neg__(self):
        return Dual(-self.v, -self.d)

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.v * o.v, self.d * _col(o.v) + _col(self.v) * o.d)
        return Dual(self.v * o, self.d * _col(o))

    def __rmul__(self, o):
        return Dual(o * self.v, _col(o) * self.d)

    def __truediv__(self, o):
        if isinstance(o, Dual):
            v = self.v / o.v
            return Dual(v, (self.d - _col(v) * o.d) / _col(o.v))
        return Dual(self.v / o, self.d / _col(o))

    def __rtruediv__(self, o):
        v = o / self.v
        return Dual(v, -(_col(v) * self.d) / _col(self.v))


def _val(x):
    return x.v if isinstance(x, Dual) else x


def _sqrt(x):
    if isinstance(x, Dual):
        s = torch.sqrt(x.v)
        return Dual(s, x.d / _col(s * 2.0))
    return torch.sqrt(x)


def _sin(x):
    if isinstance(x, Dual):
        return Dual(torch.sin(x.v), _col(torch.cos(x.v)) * x.d)
    return torch.sin(x)


def _cos(x):
    if isinstance(x, Dual):
        return Dual(torch.cos(x.v), _col(-torch.sin(x.v)) * x.d)
    return torch.cos(x)


def _atan2(y, x):
    if isinstance(y, Dual):
        den = x.v * x.v + y.v * y.v
        return Dual(torch.atan2(y.v, x.v), (_col(x.v) * y.d - _col(y.v) * x.d) / _col(den))
    return torch.atan2(y, x)


def _where(c, a, b):
    if isinstance(a, Dual) or isinstance(b, Dual):
        ad = a.d if isinstance(a, Dual) else 0.0
        bd = b.d if isinstance(b, Dual) else 0.0
        return Dual(torch.where(c, _val(a), _val(b)), torch.where(_col(c), ad, bd))
    return torch.where(c, a, b)


def _clamp(x, lo=None, hi=None):
    """torch.clamp (NaN stays NaN); the tangent passes where lo <= x <= hi."""
    v = torch.clamp(_val(x), lo, hi)
    if not isinstance(x, Dual):
        return v
    keep = torch.ones_like(v, dtype=torch.bool)
    if lo is not None:
        keep = keep & (x.v >= lo)
    if hi is not None:
        keep = keep & (x.v <= hi)
    return Dual(v, torch.where(_col(keep), x.d, 0.0))


class _C:
    """Constants on the device, for divisions (tensor by tensor)."""

    def __init__(self, dev):
        def c(x):
            return torch.full((), x, dtype=torch.float32, device=dev)
        self.one, self.two, self.c8, self.c48 = c(1.0), c(2.0), c(8.0), c(48.0)
        self.two_pi = c(2.0 * PI)
        self.grav = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float32, device=dev)
        self.half_grav = self.grav * 0.5


def _dot(a, b):
    """a[0] b[0] + a[1] b[1] + ..., from the first product."""
    s = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        s = s + x * y
    return s


def _qmul(a, b):
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    return [a0 * b0 - a1 * b1 - a2 * b2 - a3 * b3,
            a0 * b1 + a1 * b0 + a2 * b3 - a3 * b2,
            a0 * b2 - a1 * b3 + a2 * b0 + a3 * b1,
            a0 * b3 + a1 * b2 - a2 * b1 + a3 * b0]


def _qconj(q):
    return [q[0], -q[1], -q[2], -q[3]]


def _qnormalize(q):
    n = _clamp(_sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]), lo=1e-12)
    q = [x / n for x in q]
    neg = _val(q[0]) < 0
    return [_where(neg, -x, x) for x in q]


def _qmat(q):
    """Row-major R(q), the 9 entries of `quat_to_matrix`."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)]


def _so3_exp(w, c: _C):
    theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = _sqrt(_clamp(theta2, lo=1e-24))
    small = _val(theta2) < 1e-10
    half = 0.5 * theta
    sho = _where(small, 0.5 - theta2 / c.c48, _sin(half) / theta)
    cw = _where(small, 1.0 - theta2 / c.c8, _cos(half))
    return [cw, sho * w[0], sho * w[1], sho * w[2]]


def _so3_log(q, c: _C):
    neg = _val(q[0]) < 0
    q = [_where(neg, -x, x) for x in q]
    w = _clamp(q[0], -1.0, 1.0)
    vec = q[1:]
    sq = vec[0] * vec[0] + vec[1] * vec[1] + vec[2] * vec[2]
    small = _val(sq) < 1e-14
    sin_half = _sqrt(_where(small, 1.0, sq))
    half = _atan2(sin_half, w)
    scale = _where(small, c.two / _clamp(w, lo=1e-12), (2.0 * half) / _clamp(sin_half, lo=1e-24))
    return [scale * x for x in vec]


def _mv(m, x):
    """Rows of m (a list of rows, each a list) times x."""
    return [_dot(row, x) for row in m]


# ---------------------------------------------------------------------------
# The camera-only factors
# ---------------------------------------------------------------------------


def _comps(t):
    return list(t.unbind(-1))


def _imu_rows(pre, xi, xj, wb, c: _C):
    """`imu.imu_residual`'s 15 rows for each interval; xi, xj are
    (p, q, v, bg, ba) component lists of the two slots."""
    pi, qi, vi, bgi, bai = xi
    pj, qj, vj, bgj, baj = xj
    dt = pre.dt
    dbg = [bgi[a] - pre.bg[..., a] for a in range(3)]
    dba = [bai[a] - pre.ba[..., a] for a in range(3)]
    r_iw = _qmat(_qconj(qi))
    r_iw = [r_iw[0:3], r_iw[3:6], r_iw[6:9]]

    def mat(m):
        return [[m[..., a, b] for b in range(m.shape[-1])] for a in range(m.shape[-2])]

    jpbg, jpba, jvbg, jvba, jqbg = (mat(x) for x in (pre.j_p_bg, pre.j_p_ba, pre.j_v_bg,
                                                     pre.j_v_ba, pre.j_q_bg))
    dp_corr = [pre.dp[..., a] + _dot(jpbg[a], dbg) + _dot(jpba[a], dba) for a in range(3)]
    dv_corr = [pre.dv[..., a] + _dot(jvbg[a], dbg) + _dot(jvba[a], dba) for a in range(3)]
    dq_corr = _qmul(_comps(pre.dq), _so3_exp(_mv(jqbg, dbg), c))
    a_vec = [pj[a] - pi[a] - vi[a] * dt - c.half_grav[a] * dt * dt for a in range(3)]
    r_p = [x - y for x, y in zip(_mv(r_iw, a_vec), dp_corr)]
    b_vec = [vj[a] - vi[a] - c.grav[a] * dt for a in range(3)]
    r_v = [x - y for x, y in zip(_mv(r_iw, b_vec), dv_corr)]
    r_q = _so3_log(_qmul(_qconj(dq_corr), _qmul(_qconj(qi), qj)), c)
    e = r_p + r_q + r_v
    r_pqv = _mv(mat(pre.sqrt_info), e)
    return r_pqv + [(bgj[a] - bgi[a]) * wb for a in range(3)] + \
        [(baj[a] - bai[a]) * wb for a in range(3)]


def _yaw(q):
    w, x, y, z = q
    return _atan2(2 * (x * y + w * z), 1 - 2 * (y * y + z * z))


def _yaw_err(q0, anchor_yaw, c: _C):
    d_yaw = _yaw(q0) - anchor_yaw
    wrap = torch.floor((_val(d_yaw) + PI) / c.two_pi)
    return d_yaw - 2.0 * PI * wrap


class _Problem:
    """The inputs of a solve as component tensors on one device."""

    def __init__(self, state, meas, anchor_weight):
        dev = state.p.device
        self.c = _C(dev)
        self.k, self.l = state.p.shape[0], state.lm.shape[0]
        self.n = 15 * self.k
        self.kfv, self.lmv = state.kf_valid, state.lm_valid
        self.ok = meas.pre_valid & self.kfv[:-1] & self.kfv[1:]
        self.mask = self.kfv.to(torch.float32)
        self.pre = meas.pre
        self.obs = torch.nan_to_num(meas.obs)
        self.vis = meas.vis
        self.r_cb = [[meas.r_cb[a, b] for b in range(3)] for a in range(3)]
        self.p_bc = _comps(meas.p_bc)
        self.pixw, self.delta = meas.pix_weight, meas.huber_delta
        self.delta_t = torch.full((), meas.huber_delta, dtype=torch.float32, device=dev)
        self.wb, self.wba, self.wbg = meas.bias_weight, meas.ba_prior_weight, meas.bg_prior_weight
        self.aw = anchor_weight
        self.anchor_p, self.anchor_yaw = _comps(meas.anchor_p), meas.anchor_yaw
        self.prior = meas.prior
        if self.prior is not None:
            j = self.prior.j
            gram = torch.zeros((self.n, self.n), dtype=torch.float32, device=dev)
            for row in j:
                gram = gram + row[:, None] * row[None, :]
            self.gram = gram


def _cam_values(pb: _Problem, st):
    """Every camera-only residual at state st (no retraction): the IMU rows,
    the four anchor rows, the bias priors (ba then bg) and the prior's."""
    p, q, v, bg, ba = (st[i] for i in range(5))
    c = pb.c
    x = [[_comps(t[:-1]) for t in (p, q, v, bg, ba)], [_comps(t[1:]) for t in (p, q, v, bg, ba)]]
    imu = _imu_rows(pb.pre, x[0], x[1], pb.wb, c)
    imu = torch.where(pb.ok[:, None], torch.stack(imu, -1), 0.0).reshape(-1)
    anchor = [(p[0, a] - pb.anchor_p[a]) * pb.aw for a in range(3)] + \
        [_yaw_err(_comps(q[0]), pb.anchor_yaw, c) * pb.aw]
    bias = torch.cat([((ba * pb.mask[:, None]) * pb.wba).reshape(-1),
                      ((bg * pb.mask[:, None]) * pb.wbg).reshape(-1)])
    parts = [imu, torch.stack(anchor), bias]
    if pb.prior is not None:
        parts.append(_prior_rows(pb, _cld_values(pb, st)))
    return torch.cat(parts)


def _cld_values(pb: _Problem, st):
    pr = pb.prior
    rel = _so3_log(_qmul(_qconj(_comps(pr.q)), _comps(st[1])), pb.c)
    return torch.cat([(st[0] - pr.p).reshape(-1), torch.stack(rel, -1).reshape(-1),
                      (st[2] - pr.v).reshape(-1), (st[3] - pr.bg).reshape(-1),
                      (st[4] - pr.ba).reshape(-1)])


def _prior_rows(pb: _Problem, cld):
    j = pb.prior.j
    acc = j[:, 0] * cld[0]
    for i in range(1, pb.n):
        acc = acc + j[:, i] * cld[i]
    return acc + pb.prior.r0


def _seeds(shape, cols, width, dev):
    """Three duals of value 0, comp a's tangent one-hot at column cols[a]
    of `width`: a tangent step dc at 0."""
    out = []
    for col in cols:
        d = torch.zeros(tuple(shape) + (width,), dtype=torch.float32, device=dev)
        d[..., col] = 1.0
        out.append(Dual(torch.zeros(shape, dtype=torch.float32, device=dev), d))
    return out


def _seeded(vals, cols, width):
    """x + dx at dx = 0 for the comps `vals`, comp a seeded at cols[a]."""
    return [v + s for v, s in zip(vals, _seeds(vals[0].shape, cols, width, vals[0].device))]


def _retract_seeded(st, sl, base, width, c: _C):
    """Slot(s) `sl` of state st retracted at dc = 0, each comp a dual seeded
    at base + its camera-block column (p, θ, v, bg, ba)."""
    p, q, v, bg, ba = (_comps(st[i][sl]) for i in range(5))
    cols = [[base + 3 * b + a for a in range(3)] for b in range(5)]
    qr = _qnormalize(_qmul(q, _so3_exp(_seeds(p[0].shape, cols[1], width, p[0].device), c)))
    return (_seeded(p, cols[0], width), qr, _seeded(v, cols[2], width),
            _seeded(bg, cols[3], width), _seeded(ba, cols[4], width))


def _linearize_cam(pb: _Problem, st):
    """The camera-only factors at retract(st, 0): their non-prior rows'
    Jacobian as dense rows over the camera tangent (J (R, N)) with their
    values (R,), and the prior's Gram matrix and gradient (Dᵀ A D, Dᵀ jᵀ r),
    None without a prior."""
    k, n, c = pb.k, pb.n, pb.c
    dev = st[0].device
    rows, vals = [], []
    if k > 1:
        xi = _retract_seeded(st, slice(0, k - 1), 0, 30, c)
        xj = _retract_seeded(st, slice(1, k), 15, 30, c)
        imu = _imu_rows(pb.pre, xi, xj, pb.wb, c)
        jac = torch.stack([torch.where(pb.ok[:, None], r.d, 0.0) for r in imu], 1)  # (F, 15, 30)
        val = torch.where(pb.ok[:, None], torch.stack([r.v for r in imu], 1), 0.0)
        for f in range(k - 1):
            full = torch.zeros((15, n), dtype=torch.float32, device=dev)
            for s, off in ((f, 0), (f + 1, 15)):
                for b in range(5):
                    full[:, b * 3 * k + 3 * s:b * 3 * k + 3 * s + 3] = \
                        jac[f, :, off + 3 * b:off + 3 * b + 3]
            rows.append(full)
            vals.append(val[f])
    # the anchors: p0 (rows 0-2, tangent aw on dp0) and the yaw (row 3, on dθ0)
    anc = torch.zeros((4, n), dtype=torch.float32, device=dev)
    aw = torch.full((), pb.aw, dtype=torch.float32, device=dev)
    for a in range(3):
        anc[a, a] = aw
    p0 = _comps(st[0][0])
    q0 = _qnormalize(_qmul(_comps(st[1][0]), _so3_exp(_seeds((), [0, 1, 2], 3, dev), c)))
    yaw = _yaw_err(q0, pb.anchor_yaw, c) * pb.aw
    anc[3, 3 * k:3 * k + 3] = yaw.d
    rows.append(anc)
    vals.append(torch.stack([(p0[a] + 0.0 - pb.anchor_p[a]) * pb.aw for a in range(3)]
                            + [yaw.v]))
    # the bias priors: ba rows then bg rows, tangent mask x weight
    for blk, w, t in ((4, pb.wba, st[4]), (3, pb.wbg, st[3])):
        b = torch.zeros((3 * k, n), dtype=torch.float32, device=dev)
        idx = torch.arange(3 * k, device=dev)
        b[idx, blk * 3 * k + idx] = (pb.mask[:, None] * w).expand(k, 3).reshape(-1)
        rows.append(b)
        vals.append((((t + 0.0) * pb.mask[:, None]) * w).reshape(-1))
    jrows, rvals = torch.cat(rows), torch.cat(vals)
    if pb.prior is None:
        return jrows, rvals, None
    # the prior: D on the rotation blocks by duals, identity elsewhere
    pr = pb.prior
    qk = _qnormalize(_qmul(_comps(st[1]), _so3_exp(_seeds((k,), [0, 1, 2], 3, dev), c)))
    rel = _so3_log(_qmul(_qconj(_comps(pr.q)), qk), c)
    dmat = torch.stack([r.d for r in rel], 1)                   # (K, 3 rows, 3 cols)
    cld = torch.cat([(st[0] + 0.0 - pr.p).reshape(-1),
                     torch.stack([r.v for r in rel], -1).reshape(-1),
                     (st[2] + 0.0 - pr.v).reshape(-1), (st[3] + 0.0 - pr.bg).reshape(-1),
                     (st[4] + 0.0 - pr.ba).reshape(-1)])
    r_p = _prior_rows(pb, cld)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    for p_, row in enumerate(pr.j):
        u = u + row * r_p[p_]
    g = u.clone()
    ad = pb.gram.clone()
    for m in range(k):
        t0 = 3 * k + 3 * m
        for d in range(3):
            ad[:, t0 + d] = _dot([pb.gram[:, t0 + i] for i in range(3)],
                                 [dmat[m, i, d] for i in range(3)])
            g[t0 + d] = _dot([dmat[m, i, d] for i in range(3)], [u[t0 + i] for i in range(3)])
    dad = ad.clone()
    for m in range(k):
        t0 = 3 * k + 3 * m
        for d in range(3):
            dad[t0 + d] = _dot([dmat[m, i, d] for i in range(3)], [ad[t0 + i] for i in range(3)])
    return jrows, rvals, (dad, g)


# ---------------------------------------------------------------------------
# The reprojection blocks
# ---------------------------------------------------------------------------


def _project(pb: _Problem, st):
    """Camera-frame points of every (keyframe, landmark): (pts_b, pts_c, R)
    as component lists of (K, L) tensors, R row-major of (K, 1)."""
    r = [x[:, None] for x in _qmat(_comps(st[1]))]
    d = [st[5][None, :, a] - st[0][:, None, a] for a in range(3)]
    pts_b = [r[i] * d[0] + r[3 + i] * d[1] + r[6 + i] * d[2] for i in range(3)]
    e = [pts_b[a] - pb.p_bc[a] for a in range(3)]
    pts_c = [_dot(pb.r_cb[i], e) for i in range(3)]
    return pts_b, pts_c, r


def _residuals(pb: _Problem, st, pts_c):
    """(valid, r (2 comps), rn, s, r_out (2 comps)) of `reprojection_jacobians`."""
    x, y, z = pts_c
    zs = torch.where(torch.abs(z) > 1e-6, z, 1e-6)
    valid = pb.vis & (z > 0.05) & pb.kfv[:, None] & pb.lmv[None, :]
    r = [(x / zs - pb.obs[..., 0]) * pb.pixw, (y / zs - pb.obs[..., 1]) * pb.pixw]
    rn = torch.sqrt(r[0] * r[0] + r[1] * r[1])
    s = torch.sqrt(torch.clamp(pb.delta_t / torch.clamp(rn, min=1e-9), max=1.0))
    r_out = [torch.where(valid, ri * s, 0.0) for ri in r]
    return valid, zs, r, rn, s, r_out


def _proj_cost_terms(pb: _Problem, st):
    """Per landmark: Σ over keyframes of |r_out|², in slot order from +0."""
    _, pts_c, _ = _project(pb, st)
    r_out = _residuals(pb, st, pts_c)[5]
    acc = torch.zeros(pb.l, dtype=torch.float32, device=st[0].device)
    for kk in range(pb.k):
        acc = acc + (r_out[0][kk] * r_out[0][kk] + r_out[1][kk] * r_out[1][kk])
    return acc


def _obs_blocks(pb: _Problem, st):
    """Every observation's closed-form blocks: valid (K, L), r_out (K, L, 2),
    Jp (K, L, 2, 6) over [dp_k, dθ_k] and Jl (K, L, 2, 3), zero where not
    valid."""
    pts_b, pts_c, rm = _project(pb, st)
    x, y, _ = pts_c
    valid, zs, r, rn, s, r_out = _residuals(pb, st, pts_c)
    one = pb.c.one
    inv_z = one / zs
    zero = torch.zeros_like(inv_z)
    dproj = [[inv_z, zero, -x * inv_z * inv_z], [zero, inv_z, -y * inv_z * inv_z]]
    big = rn > pb.delta
    den = torch.clamp(rn * rn, min=1e-18)
    hub = [[s * ((1.0 if a == b else 0.0) - torch.where(big, 0.5 * ((r[a] * r[b]) / den), 0.0))
            for b in range(2)] for a in range(2)]
    m1 = [[hub[a][0] * dproj[0][cc] + hub[a][1] * dproj[1][cc] for cc in range(3)]
          for a in range(2)]
    jb = [[pb.pixw * _dot(m1[a], [pb.r_cb[i][cc] for i in range(3)]) for cc in range(3)]
          for a in range(2)]
    jl = [[_dot(jb[a], [rm[3 * cc + j] for j in range(3)]) for cc in range(3)] for a in range(2)]
    zero_b = torch.zeros_like(pts_b[0])
    hat = [[zero_b, -pts_b[2], pts_b[1]], [pts_b[2], zero_b, -pts_b[0]],
           [-pts_b[1], pts_b[0], zero_b]]
    jt = [[_dot(jb[a], [hat[j][cc] for j in range(3)]) for cc in range(3)] for a in range(2)]
    jp = torch.stack([torch.stack([-jl[a][0], -jl[a][1], -jl[a][2]] + jt[a], -1)
                      for a in range(2)], -2)
    jlt = torch.stack([torch.stack(jl[a], -1) for a in range(2)], -2)
    v4 = valid[..., None, None]
    return (valid, torch.stack(r_out, -1), torch.where(v4, jp, 0.0), torch.where(v4, jlt, 0.0))


def _inv3(h):
    """The adjugate over the determinant of (..., 3, 3)."""
    e = [[h[..., a, b] for b in range(3)] for a in range(3)]
    adj = [[e[1][1] * e[2][2] - e[1][2] * e[2][1], e[0][2] * e[2][1] - e[0][1] * e[2][2],
            e[0][1] * e[1][2] - e[0][2] * e[1][1]],
           [e[1][2] * e[2][0] - e[1][0] * e[2][2], e[0][0] * e[2][2] - e[0][2] * e[2][0],
            e[0][2] * e[1][0] - e[0][0] * e[1][2]],
           [e[1][0] * e[2][1] - e[1][1] * e[2][0], e[0][1] * e[2][0] - e[0][0] * e[2][1],
            e[0][0] * e[1][1] - e[0][1] * e[1][0]]]
    det = e[0][0] * adj[0][0] + e[0][1] * adj[1][0] + e[0][2] * adj[2][0]
    return torch.stack([torch.stack([adj[a][b] / det for b in range(3)], -1)
                        for a in range(3)], -2)


def _pair(a, b):
    """a[..., 0, :] b[..., 0, :] + a[..., 1, :] b[..., 1, :] as (..., m, n)."""
    return a[..., 0, :, None] * b[..., 0, None, :] + a[..., 1, :, None] * b[..., 1, None, :]


# ---------------------------------------------------------------------------
# Sums, the factorization, the solve
# ---------------------------------------------------------------------------


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """The kernel's block-wide sum of (n,): element i into lane i mod 1024
    in index order from +0, then halving over the 32 lanes of each warp
    (offsets 16, 8, 4, 2, 1) and over the 32 warps' sums the same way."""
    n = v.shape[0]
    cols = max(1, -(-n // BLOCK))
    padded = torch.zeros(cols * BLOCK, dtype=v.dtype, device=v.device)
    padded[:n] = v
    acc = torch.zeros(BLOCK, dtype=v.dtype, device=v.device)
    for i in range(cols):
        acc = acc + padded[i * BLOCK:(i + 1) * BLOCK]
    lanes = acc.view(BLOCK // WARP, WARP)
    half = WARP // 2
    while half:
        lanes = lanes[:, :half] + lanes[:, half:2 * half]
        half //= 2
    warps = lanes[:, 0]
    half = warps.shape[0] // 2
    while half:
        warps = warps[:half] + warps[half:2 * half]
        half //= 2
    return warps[0]


def _cholesky_solve(a: torch.Tensor, b: torch.Tensor):
    """Right-looking Cholesky of the lower triangle of a with b as an extra
    row (forward substitution), then the back substitution. NaN where a
    pivot is not positive."""
    n = a.shape[0]
    a, y = a.clone(), b.clone()
    fail = torch.zeros((), dtype=torch.bool, device=a.device)
    for j in range(n):
        ajj = a[j, j]
        fail = fail | ~(ajj > 0)
        ljj = torch.sqrt(ajj)
        col = a[j + 1:, j] / ljj
        a[j + 1:, j] = col
        a[j, j] = ljj
        yj = y[j] / ljj
        y[j] = yj
        a[j + 1:, j + 1:] = a[j + 1:, j + 1:] - col[:, None] * col[None, :]
        y[j + 1:] = y[j + 1:] - col * yj
    x = y
    for j in reversed(range(n)):
        xj = x[j] / a[j, j]
        x[j] = xj
        x[:j] = x[:j] - a[j, :j] * xj
    return torch.where(fail, float("nan"), x)


def _lower(m: torch.Tensor) -> torch.Tensor:
    """The matrix whose both triangles are m's lower one."""
    return torch.tril(m) + torch.tril(m, -1).T


def _retract(pb: _Problem, st, dc, dl):
    k = pb.k
    d = dc.reshape(5, k, 3)
    q = _qnormalize(_qmul(_comps(st[1]), _so3_exp(_comps(d[1]), pb.c)))
    return (st[0] + d[0], torch.stack(q, -1), st[2] + d[2], st[3] + d[3], st[4] + d[4],
            st[5] + dl)


def _total_cost(pb: _Problem, st):
    cam = _cam_values(pb, st)
    return 0.5 * block_sum(cam * cam) + 0.5 * block_sum(_proj_cost_terms(pb, st))


def solve(state, meas, iters: int, init_lambda: float, anchor_weight: float):
    """`solve_window_fast` in the kernel's order; returns (state, cost)."""
    pb = _Problem(state, meas, anchor_weight)
    k, l, n, c = pb.k, pb.l, pb.n, pb.c
    dev = state.p.device
    f32 = torch.float32
    st = (state.p, state.q, state.v, state.bg, state.ba, state.lm)
    lam = torch.full((), init_lambda, dtype=f32, device=dev)
    cost = _total_cost(pb, st)
    pose = torch.arange(6 * k, device=dev)
    # a pose column's keyframe and its comp of [dp, dθ]
    pose_k = torch.where(pose < 3 * k, pose // 3, (pose - 3 * k) // 3)
    pose_a = torch.where(pose < 3 * k, pose % 3, 3 + (pose - 3 * k) % 3)
    same_k = pose_k[:, None] == pose_k[None, :]
    idx = torch.arange(n, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    for _ in range(iters):
        jrows, rvals, prior = _linearize_cam(pb, st)
        h = torch.zeros((n, n), dtype=f32, device=dev)
        g = torch.zeros(n, dtype=f32, device=dev)
        if prior is not None:
            h = h + prior[0]
            g = g + prior[1]
        for row, rv in zip(jrows, rvals):
            h = h + row[:, None] * row[None, :]
            g = g + row * rv
        valid, r_out, jp, jl = _obs_blocks(pb, st)
        h_ll = torch.zeros((l, 3, 3), dtype=f32, device=dev)
        g_l = torch.zeros((l, 3), dtype=f32, device=dev)
        for kk in range(k):
            h_ll = h_ll + _pair(jl[kk], jl[kk])
            g_l = g_l + (jl[kk, :, 0] * r_out[kk, :, 0:1] + jl[kk, :, 1] * r_out[kk, :, 1:2])
        h_pl = _pair(jp, jl)                                              # (K, L, 6, 3)
        a_h = torch.abs(h_ll).reshape(l, 9)
        abs_sum = a_h[:, 0]
        for i in range(1, 9):
            abs_sum = abs_sum + a_h[:, i]
        observed = abs_sum > 1e-12
        h_ll_d = h_ll + torch.diag_embed(lam * (torch.diagonal(h_ll, dim1=-2, dim2=-1) + 1e-6))
        h_ll_d = torch.where(eye3 > 0, h_ll_d, h_ll)
        h_inv = torch.where(observed[:, None, None], _inv3(h_ll_d), eye3)
        w = (h_pl[..., 0, None] * h_inv[None, :, 0, None, :]
             + h_pl[..., 1, None] * h_inv[None, :, 1, None, :]) \
            + h_pl[..., 2, None] * h_inv[None, :, 2, None, :]            # (K, L, 6, 3)
        # the sums over landmarks, in index order from +0
        h_pp = torch.zeros((k, 6, 6), dtype=f32, device=dev)
        g_p = torch.zeros((k, 6), dtype=f32, device=dev)
        schur = torch.zeros((k, 6, k, 6), dtype=f32, device=dev)
        corr = torch.zeros((k, 6), dtype=f32, device=dev)
        for li in range(l):
            vk = valid[:, li]
            jpl = jp[:, li]
            h_pp = torch.where(vk[:, None, None], h_pp + _pair(jpl, jpl), h_pp)
            g_p = torch.where(vk[:, None], g_p + (jpl[:, 0] * r_out[:, li, 0:1]
                                                  + jpl[:, 1] * r_out[:, li, 1:2]), g_p)
            wl, hl = w[:, li], h_pl[:, li]
            t = (wl[:, :, None, None, 0] * hl[None, None, :, :, 0]
                 + wl[:, :, None, None, 1] * hl[None, None, :, :, 1]) \
                + wl[:, :, None, None, 2] * hl[None, None, :, :, 2]
            both = vk[:, None, None, None] & vk[None, None, :, None]
            schur = torch.where(both, schur + t, schur)
            gl = g_l[li]
            corr = torch.where(vk[:, None], corr + ((wl[..., 0] * gl[0] + wl[..., 1] * gl[1])
                                                    + wl[..., 2] * gl[2]), corr)
        # the reduced camera system (lower triangle)
        h_cc = h.clone()
        blk = h_pp[pose_k[:, None], pose_a[:, None], pose_a[None, :]]
        h_cc[:6 * k, :6 * k] = torch.where(same_k, h[:6 * k, :6 * k] + blk, h[:6 * k, :6 * k])
        h_cc = _lower(h_cc)
        g_c = g.clone()
        g_c[:6 * k] = g[:6 * k] + g_p[pose_k, pose_a]
        diag = torch.diagonal(h_cc)
        h_red = h_cc.clone()
        h_red[idx, idx] = diag + lam * (diag + 1e-6)
        s_cam = schur[pose_k[:, None], pose_a[:, None], pose_k[None, :], pose_a[None, :]]
        h_red[:6 * k, :6 * k] = h_red[:6 * k, :6 * k] - s_cam
        g_red = g_c.clone()
        g_red[:6 * k] = g_c[:6 * k] - corr[pose_k, pose_a]
        d = c.one / torch.sqrt(torch.diagonal(h_red) + 1e-12)
        x = _cholesky_solve(h_red * d[:, None] * d[None, :], -(g_red * d))
        dc = d * x
        # the landmarks, back-substituted
        dcp = torch.stack([dc[:3 * k].reshape(k, 3), dc[3 * k:6 * k].reshape(k, 3)], 1) \
            .reshape(k, 6)
        u = torch.zeros((l, 3), dtype=f32, device=dev)
        for kk in range(k):
            t = h_pl[kk, :, 0] * dcp[kk, 0]
            for a in range(1, 6):
                t = t + h_pl[kk, :, a] * dcp[kk, a]
            u = torch.where(valid[kk][:, None], u + t, u)
        rhs = -g_l - u
        dl = (h_inv[:, :, 0] * rhs[:, 0:1] + h_inv[:, :, 1] * rhs[:, 1:2]) \
            + h_inv[:, :, 2] * rhs[:, 2:3]
        dl = torch.where(observed[:, None], dl, 0.0)
        st_new = _retract(pb, st, dc, dl)
        cost_new = _total_cost(pb, st_new)
        # the predicted reduction
        hdc = h_cc[:, 0] * dc[0]
        for j in range(1, n):
            hdc = hdc + h_cc[:, j] * dc[j]
        hv = [_dot([h_ll[:, a, b] for b in range(3)], [dl[:, b] for b in range(3)])
              for a in range(3)]
        s_gc = block_sum(g_c * dc)
        s_qcc = block_sum(dc * hdc)
        s_gl = block_sum(_dot([g_l[:, a] for a in range(3)], [dl[:, a] for a in range(3)]))
        s_qcl = block_sum(_dot([u[:, a] for a in range(3)], [dl[:, a] for a in range(3)]))
        s_qll = block_sum(_dot([dl[:, a] for a in range(3)], hv))
        pred = -(s_gc + s_gl) - 0.5 * (s_qcc + 2.0 * s_qcl + s_qll)
        accept = cost_new < cost
        rho = (cost - cost_new) / torch.clamp(pred, min=1e-12)
        t = 2.0 * rho - 1.0
        shrink = torch.clamp(1.0 - t * t * t, min=1.0 / 3.0)
        st = tuple(torch.where(accept, a, b) for a, b in zip(st_new, st))
        lam = torch.where(accept, torch.clamp(lam * shrink, min=1e-10),
                          torch.clamp(lam * 4.0, max=1e8))
        cost = torch.where(accept, cost_new, cost)
    return state._replace(p=st[0], q=st[1], v=st[2], bg=st[3], ba=st[4], lm=st[5]), cost
