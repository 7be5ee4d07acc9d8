"""Two-view geometry: essential-matrix RANSAC, pose recovery, ray depths.

Counterpart of ``feature_detector_fast_tpu.models.twoview``.  RANSAC is a
batch of H hypotheses solved and scored together, then an argmax: no loop,
no early exit.  Every function takes leading batch dimensions, so the
sequence's P pairs and their H hypotheses are one set of tensor operations
((P, H, ...) shapes), never a Python loop over pairs or hypotheses.

The uniform draws that rank each hypothesis's minimal sample are an input
(``ransac_essential``'s ``draws``): the JAX package draws them from a
``jax.random`` key, which PyTorch cannot reproduce, so a caller passes its
own (``slam.ransac_draws``) or the JAX ones.

All math is in normalized camera coordinates (``normalize_points``).
Functions follow their inputs' dtype and device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class Camera(NamedTuple):
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float

    def matrix(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                            dtype=dtype, device=device)


def camera_from(obj) -> Camera:
    """The port's Camera from any object with ``fx, fy, cx, cy`` attributes
    (a JAX ``Camera``) or keys (a dict)."""
    get = obj.__getitem__ if isinstance(obj, dict) else lambda k: getattr(obj, k)
    return Camera(*(float(get(k)) for k in Camera._fields))


def normalize_points(pts: torch.Tensor, cam: Camera) -> torch.Tensor:
    """Pixel (..., 2) -> normalized camera coordinates (..., 2)."""
    x = (pts[..., 0] - cam.cx) / cam.fx
    y = (pts[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3) matrices (no LU, no host
    check)."""
    return (M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :], dim=-1)).sum(-1)


def _epipolar_rows(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """(..., N, 9) epipolar constraint rows: row_i . vec(E) = pb_i^T E pa_i."""
    xa, ya = pa[..., 0], pa[..., 1]
    xb, yb = pb[..., 0], pb[..., 1]
    return torch.stack([xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya, torch.ones_like(xa)],
                       dim=-1)


def _sym3_eigs_smallest(M: torch.Tensor):
    """Closed-form eigensystem pieces of symmetric PSD (..., 3, 3) matrices:
    (lam1, lam2, lam3, v3) with lam1 >= lam2 >= lam3 (Cardano's
    trigonometric solution of the characteristic cubic) and v3 the unit
    eigenvector of lam3 (the best-conditioned cross product of two rows of
    M - lam3 I).  Elementwise arithmetic only."""
    eye = _eye(3, M)
    q = M.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    Mq = M - q[..., None, None] * eye
    p2 = (Mq * Mq).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = Mq / p[..., None, None]
    detB = (B[..., 0, 0] * (B[..., 1, 1] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 1])
            - B[..., 0, 1] * (B[..., 1, 0] * B[..., 2, 2] - B[..., 1, 2] * B[..., 2, 0])
            + B[..., 0, 2] * (B[..., 1, 0] * B[..., 2, 1] - B[..., 1, 1] * B[..., 2, 0]))
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    S = M - lam3[..., None, None] * eye
    cands = torch.stack([torch.linalg.cross(S[..., 0, :], S[..., 1, :], dim=-1),
                         torch.linalg.cross(S[..., 0, :], S[..., 2, :], dim=-1),
                         torch.linalg.cross(S[..., 1, :], S[..., 2, :], dim=-1)], dim=-2)
    norms = torch.linalg.vector_norm(cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return lam1, lam2, lam3, v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                             min=1e-30)


def _essential_project(E: torch.Tensor) -> torch.Tensor:
    """Closed-form projection of (..., 3, 3) matrices onto the essential
    manifold (singular values (s, s, 0)), with no SVD:

        E_ess = sbar * E (a M + b I)(I - v3 v3^T),   M = E^T E,

    where (a, b) interpolate f(lam) = 1 / sqrt(lam) through lam1, lam2, so
    on the rank-2 span a M + b I is V diag(1/s1, 1/s2) V^T without forming
    v1, v2; where lam1 - lam2 underflows, the analytic limit
    a = -1 / (2 lbar^(3/2)) takes over."""
    M = E.transpose(-1, -2) @ E
    lam1, lam2, _, v3 = _sym3_eigs_smallest(M)
    eps = 1e-30
    lam1 = torch.clamp(lam1, min=eps)
    lam2 = torch.clamp(lam2, min=eps)
    s1 = torch.sqrt(lam1)
    s2 = torch.sqrt(lam2)
    sbar = 0.5 * (s1 + s2)
    dl = lam1 - lam2
    lbar = 0.5 * (lam1 + lam2)
    a_nd = (1.0 / s1 - 1.0 / s2) / torch.where(dl.abs() < eps, 1.0, dl)
    a_deg = -0.5 / (lbar * torch.sqrt(lbar))
    deg = dl.abs() < 1e-6 * lam1
    a = torch.where(deg, a_deg, a_nd)
    b = torch.where(deg, 1.5 / torch.sqrt(lbar), 1.0 / s1 - a_nd * lam1)
    eye = _eye(3, E)
    W = a[..., None, None] * M + b[..., None, None] * eye
    P = eye - v3[..., :, None] * v3[..., None, :]
    return sbar[..., None, None] * (E @ (W @ P))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1, keepdim=True)


def _nullvec_rows8(A: torch.Tensor) -> torch.Tensor:
    """Unit vector orthogonal to the 8 rows of A (..., 8, 9): the 8-point null
    vector by unrolled modified Gram-Schmidt with one re-orthogonalization
    pass, on the rows (not the normal matrix, whose squared conditioning
    costs float32 accuracy).  Every step is an elementwise operation over
    the leading dimensions.  Two fixed deflation seeds guard against a seed
    in the row space; the larger deflated residual wins."""
    eps = 1e-30
    q = []
    for i in range(8):
        v = A[..., i, :]
        for _ in range(2):  # MGS + re-orthogonalization
            for qj in q:
                v = v - _dot(qj, v) * qj
        q.append(v / torch.sqrt(torch.clamp(_dot(v, v), min=eps)))

    def deflate(seed):
        v = seed
        for _ in range(2):
            for qj in q:
                v = v - _dot(qj, v) * qj
        return v

    s1 = deflate(torch.full((9,), 1.0 / 3.0, dtype=A.dtype, device=A.device).expand(q[0].shape))
    alt = torch.zeros(9, dtype=A.dtype, device=A.device)
    alt[4] = 1.0
    alt[2] = -0.5
    s2 = deflate(alt.expand(q[0].shape))
    n1 = _dot(s1, s1)
    n2 = _dot(s2, s2)
    v = torch.where(n1 >= n2, s1, s2)
    return v / torch.sqrt(torch.clamp(torch.maximum(n1, n2), min=eps))


def _eight_point_hyp(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """RANSAC hypothesis 8-point solve, SVD-free: the row-space null vector
    (``_nullvec_rows8``) of (..., 8, 2) samples, then the closed-form
    essential projection."""
    A = _epipolar_rows(pa, pb)
    E = _nullvec_rows8(A).reshape(*A.shape[:-2], 3, 3)
    return _essential_project(E)


def _project_svd(E: torch.Tensor) -> torch.Tensor:
    """Projection onto the essential manifold through a 3x3 SVD."""
    u, s, vt = torch.linalg.svd(E)
    sbar = (s[..., 0] + s[..., 1]) / 2.0
    s_proj = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    return u @ (s_proj[..., :, None] * vt)


def _eight_point(pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Essential matrix from >= 8 normalized correspondences (..., N, 2):
    the null-ish singular vector of the constraint rows, projected onto
    the essential manifold."""
    _, _, vt = torch.linalg.svd(_epipolar_rows(pa, pb), full_matrices=True)
    e = vt[..., -1, :]
    return _project_svd(e.reshape(*e.shape[:-1], 3, 3))


def sampson_error(E: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) epipolar error: E (..., 3, 3), pa, pb
    (..., N, 2) normalized (broadcast against E's leading dimensions);
    returns (..., N)."""
    ha = _homogeneous(pa)
    hb = _homogeneous(pb)
    Ea = ha @ E.transpose(-1, -2)  # rows (E pa)^T
    Etb = hb @ E
    num = (hb * Ea).sum(-1) ** 2
    den = Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2 + Etb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., H, *tail)[idx (...,)] -> (..., *tail)."""
    tail = x.shape[idx.dim() + 1:]
    g = idx.reshape(*idx.shape, 1, *(1,) * len(tail)).expand(*idx.shape, 1, *tail)
    return torch.gather(x, idx.dim(), g).squeeze(idx.dim())


def minimal_samples(valid: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
    """(..., H, 8) slot indices of each hypothesis's minimal sample: the 8
    slots of lowest draw, invalid slots ranked last at 2.0 (8 distinct
    valid slots whenever 8 exist).  A stable sort breaks the tied 2.0s by
    index, lowest first, as ``jax.lax.top_k`` does, so every device takes
    the same sample (``torch.topk`` promises no tie order)."""
    r = torch.where(valid[..., None, :], draws, 2.0)
    return torch.sort(r, dim=-1, stable=True).indices[..., :8]


def ransac_essential(pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor,
                     draws: torch.Tensor, threshold: float = 1e-4
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-hypothesis RANSAC for E.

    pa, pb: (..., K, 2) normalized correspondences (slots); valid: (..., K)
    bool; draws: (..., H, K) uniform draws in [0, 1), one row per
    hypothesis.  Returns (E (..., 3, 3), inlier mask (..., K)).  All H
    hypotheses are solved and scored together, then the best is refit on
    its inliers twice, keeping whichever model has the larger consensus."""
    k = pa.shape[-2]
    idx = minimal_samples(valid, draws)  # (..., H, 8)
    h = idx.shape[-2]
    lead = idx.shape[:-2]

    def sample(p):
        return torch.gather(p[..., None, :, :].expand(*lead, h, k, 2), -2,
                            idx[..., None].expand(*lead, h, 8, 2))

    Es = _eight_point_hyp(sample(pa), sample(pb))  # (..., H, 3, 3)
    errs = sampson_error(Es, pa[..., None, :, :], pb[..., None, :, :])  # (..., H, K)
    inl = (errs < threshold) & valid[..., None, :]
    scores = inl.sum(-1)
    best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax

    E_final = _take(Es, best)
    inl_final = _take(inl, best)
    score_final = _take(scores, best)
    for _ in range(2):
        w = inl_final.to(pa.dtype)[..., None]
        E_refit = _eight_point_weighted(pa, pb, w)
        inl_refit = (sampson_error(E_refit, pa, pb) < threshold) & valid
        n_refit = inl_refit.sum(-1)
        use = n_refit >= score_final
        E_final = torch.where(use[..., None, None], E_refit, E_final)
        inl_final = torch.where(use[..., None], inl_refit, inl_final)
        score_final = torch.maximum(n_refit, score_final)
    return E_final, inl_final


def _eight_point_weighted(pa: torch.Tensor, pb: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Inlier-weighted refit: the smallest eigenvector of the (..., 9, 9)
    normal matrix (symmetrized, as ``jnp.linalg.eigh`` does), projected onto
    the essential manifold by a 3x3 SVD.  The normal matrix squares the
    conditioning, as the JAX package's float32 form does; a refit is
    compared with a tolerance."""
    A = _epipolar_rows(pa, pb) * w
    N = A.transpose(-1, -2) @ A
    # The eigen-solve runs in float64 whatever the dtype: a float32 solver
    # need not separate the two smallest eigenvalues of this matrix, whose
    # conditioning is squared, and cuSOLVER's float32 one on the H100 missed
    # the smallest eigenvector on real pairs where LAPACK's did not
    # (chip_smoke.py's VO phase prints both).  N itself is formed in the
    # input dtype, as the reference forms it.
    _, V = torch.linalg.eigh(((N + N.transpose(-1, -2)) / 2.0).double())
    E = V[..., :, 0].to(N.dtype).reshape(*V.shape[:-2], 3, 3)  # eigh sorts ascending
    return _project_svd(E)


def triangulate(Ra: torch.Tensor, ta: torch.Tensor, Rb: torch.Tensor, tb: torch.Tensor,
                pa: torch.Tensor, pb: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation of (N, 2) normalized correspondences from
    world -> camera extrinsics (Ra|ta), (Rb|tb); returns (N, 3) world
    points."""
    Pa = torch.cat([Ra, ta[..., None]], dim=-1)  # (3, 4)
    Pb = torch.cat([Rb, tb[..., None]], dim=-1)
    rows = torch.stack([pa[:, 0:1] * Pa[2] - Pa[0], pa[:, 1:2] * Pa[2] - Pa[1],
                        pb[:, 0:1] * Pb[2] - Pb[0], pb[:, 1:2] * Pb[2] - Pb[1]], dim=1)
    _, _, vt = torch.linalg.svd(rows)
    X = vt[:, -1]
    return X[:, :3] / torch.where(X[:, 3:].abs() < 1e-12, 1e-12, X[:, 3:])


def ray_depths(R: torch.Tensor, t: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form two-view ray depths: the least-squares (za, zb) of
    za (R qa) - zb qb + t = 0 along qa = [pa, 1], qb = [pb, 1] (convention
    x_b = R x_a + t), a 2x2 Cramer solution per correspondence.  R (..., 3,
    3), t (..., 3), pa, pb (..., N, 2) -> (za, zb) (..., N).  Near-parallel
    rays give a clamped near-zero denominator and huge depths, which every
    consumer gates."""
    qa = _homogeneous(pa)
    qb = _homogeneous(pb)
    u = qa @ R.transpose(-1, -2)  # rotated first-frame rays
    uu = (u * u).sum(-1)
    vv = (qb * qb).sum(-1)
    uv = (u * qb).sum(-1)
    ut = (u * t[..., None, :]).sum(-1)
    vt = (qb * t[..., None, :]).sum(-1)
    den = uu * vv - uv * uv
    den = torch.where(den.abs() < 1e-12, 1e-12, den)
    za = (uv * vt - ut * vv) / den
    zb = (uu * vt - uv * ut) / den
    return za, zb


def recover_pose(E: torch.Tensor, pa: torch.Tensor, pb: torch.Tensor, valid: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decompose E (..., 3, 3) into the (R, t) with the most correspondences
    in front of both cameras (camera A at identity, x_b = R x_a + t).
    Returns (R (..., 3, 3), unit t (..., 3), support (...,)); the four
    candidates are scored together."""
    u, _, vt = torch.linalg.svd(E)
    # Proper rotations U and V (negating an orthogonal matrix with det -1),
    # so U W V^T and U W^T V^T are rotations.
    u = u * torch.sign(_det3(u))[..., None, None]
    vt = vt * torch.sign(_det3(vt))[..., None, None]
    # U W and U W^T for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]]: U's columns
    # permuted and negated, exactly what the products give.
    u0, u1, u2 = u[..., :, 0], u[..., :, 1], u[..., :, 2]
    R1 = torch.stack([u1, -u0, u2], dim=-1) @ vt
    R2 = torch.stack([-u1, u0, u2], dim=-1) @ vt
    t = u2
    t = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    ts = torch.stack([t, -t, t, -t], dim=-2)  # (..., 4, 3)
    za, zb = ray_depths(Rs, ts, pa[..., None, :, :], pb[..., None, :, :])  # (..., 4, N)
    finite = torch.isfinite(za) & torch.isfinite(zb)
    supports = ((za > 1e-6) & (zb > 1e-6) & valid[..., None, :] & finite).sum(-1)
    best = torch.argmax(supports, dim=-1)
    return _take(Rs, best), _take(ts, best), _take(supports, best)
