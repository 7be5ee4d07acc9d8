"""Plain references of the SLAM cell's loop stages, in PyTorch float64 on
whatever device the inputs are given on: loop proposal, the robust loop
pose graph, rotation averaging, and the multi-view triangulation and gating
that build each round of bundle adjustment.  Written from the published
methods and the port's documented algorithm (``models/slam.py``,
``models/posegraph.py``); it imports nothing of the port.

* Loop proposal (Galvez-Lopez & Tardos 2012 use a bag of words; the port a
  pooled bag of bits): a frame's signature is the mean of each of its 256
  BRIEF bits over its valid keypoints; signatures are centred by their mean
  over the sequence and compared by cosine; frame i is matched with its
  ``top_k`` most similar frames j >= i + ``gap`` by mutual nearest
  neighbours in Hamming distance (``reference.brief.match``), and a pair
  with at least ``min_matches`` matches is kept.  Departure: similarities
  in float64, where the port ranks float32 ones; two partners within a
  float32 rounding of each other at the ``top_k`` cut could rank apart.
* The pose graph (Kummerle et al. 2011, g2o's SE(3) edges): residual
  log(Z_e^-1 T_i^-1 T_j) times the edge's weight; Levenberg-Marquardt on
  left increments T <- exp(d) T with pose 0 fixed, lambda from 1e-6, divided
  by 3 on an accepted step (not below 1e-9) and multiplied by 8 on a
  rejected one (not above 1e8).  With a robust scale delta the weights are
  reset each step to w delta^2 / (delta^2 + rho^2) (Cauchy, rho the
  residual's weighted norm) and a step is accepted where it lowers the
  Geman-McClure cost sum delta^2 rho^2 / (delta^2 + rho^2) (Geman &
  McClure 1987), as the port does.  The normal equations are solved
  densely.  Departure: the Jacobian by central differences (step 1e-6) in
  place of automatic differentiation.
* Rotation averaging (Chatterjee & Govindu 2013): IRLS on left increments
  of the absolute rotations, Cauchy weights at 0.1 rad, a Laplacian solve
  with rotation 0 fixed, 8 rounds.
* Triangulation: each track's linear (DLT, Hartley & Zisserman 12.2) point
  from every observation, the smallest eigenvector of its 4 x 4 normal
  matrix.  Gating keeps an observation in front of its camera (depth >
  1e-3) that reprojects within 0.02 normalized units, and of a track only
  what keeps two or more such observations.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import brief, se3

F64 = torch.float64


def tf32_off() -> None:
    """Full float32 matmuls wherever the references run beside the program:
    their float64 work never uses TF32, and this keeps it so for any float32
    input they touch."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- loop proposal


def signatures(desc: torch.Tensor, dvalid: torch.Tensor) -> torch.Tensor:
    """(F, 256) float64: each BRIEF bit's mean over a frame's valid slots
    (0 where it has none).  Bit b of word w is signature entry 32 w + b."""
    shifts = torch.arange(32, device=desc.device)
    bits = ((desc.to(torch.int64)[..., None] >> shifts) & 1).to(F64)
    bits = bits.reshape(desc.shape[0], desc.shape[1], -1)
    w = dvalid.to(F64)
    return (bits * w[..., None]).sum(1) / w.sum(1).clamp(min=1.0)[:, None]


def candidates(desc, dvalid, gap: int, top_k: int) -> List[Tuple[int, int]]:
    """(i, j) pairs, i ascending and j ascending within i: frame i's
    ``top_k`` most similar partners j >= i + gap (all of them with 0)."""
    f = desc.shape[0]
    sig = signatures(desc, dvalid)
    sig = sig - sig.mean(0)
    nrm = torch.linalg.vector_norm(sig, dim=1)
    sim = (sig @ sig.T) / torch.clamp(nrm[:, None] * nrm[None, :], min=1e-9)
    out = []
    for i in range(max(0, f - gap)):
        js = torch.arange(i + gap, f, device=desc.device)
        if top_k and len(js):
            order = torch.sort(-sim[i, js], stable=True).indices[:top_k]
            js = torch.sort(js[order]).values
        out.extend((i, int(j)) for j in js)
    return out


def propose(desc, dvalid, gap: int, top_k: int, min_matches: int):
    """The kept loop pairs: [(i, j, idx (K,) int64: frame i's matched slot of
    frame j, or -1)] in candidate order, of (F, K, 8) descriptors."""
    out = []
    for i, j in candidates(desc, dvalid, gap, top_k):
        idx = brief.match(desc[i], dvalid[i], desc[j], dvalid[j])
        if int((idx >= 0).sum()) >= min_matches:
            out.append((i, j, idx))
    return out


# -- the pose graph


def _edge_residuals(Ti, Tj, Z, weight):
    """(E, 6) log(Z^-1 Ti^-1 Tj) * weight."""
    return se3.se3_log(se3.inverse(Z) @ se3.inverse(Ti) @ Tj) * weight[:, None]


def _edge_jacobians(Ti, Tj, Z, weight, h: float = 1e-6):
    """(E, 6, 6) each of the edge residual's Jacobians with respect to a
    left increment of T_i and of T_j, by central differences (all 24
    displaced ends in one evaluation)."""
    eye = torch.eye(6, dtype=F64, device=Ti.device) * h
    steps = se3.se3_exp(torch.cat([eye, -eye]))[:, None]  # (12, 1, 4, 4)
    e = Ti.shape[0]
    still_i, still_j = Ti.expand(12, e, 4, 4), Tj.expand(12, e, 4, 4)
    moved = _edge_residuals(torch.cat([steps @ Ti, still_i]).reshape(-1, 4, 4),
                            torch.cat([still_j, steps @ Tj]).reshape(-1, 4, 4),
                            Z.repeat(24, 1, 1), weight.repeat(24)).reshape(2, 2, 6, e, 6)
    # (end, sign, dim, edge, residual) -> per end (edge, residual, dim)
    return tuple(((m[0] - m[1]) / (2.0 * h)).permute(1, 2, 0) for m in moved)


def _graph(poses, edge_i, edge_j, edge_T, edge_valid, edge_weight):
    """The graph's tensors in float64 (indices int64) on ``poses``' device."""
    dev = poses.device
    return (poses.to(F64), edge_i.to(dev).long(), edge_j.to(dev).long(), edge_T.to(dev, F64),
            torch.where(edge_valid.to(dev), edge_weight.to(dev, F64), 0.0))


def _cost(poses, ei, ej, Z, w, robust_delta: float) -> torch.Tensor:
    rho2 = (_edge_residuals(poses[ei], poses[ej], Z, w) ** 2).sum(-1)
    if robust_delta <= 0:
        return rho2.sum()
    d2 = robust_delta * robust_delta
    return (d2 * rho2 / (d2 + rho2)).sum()


def graph_cost(poses, edge_i, edge_j, edge_T, edge_valid, edge_weight,
               robust_delta: float = 0.0) -> float:
    """The cost that the LM steps lower: Geman-McClure with a robust scale,
    else the sum of squares."""
    tf32_off()
    return float(_cost(*_graph(poses, edge_i, edge_j, edge_T, edge_valid, edge_weight),
                       robust_delta))


def pose_graph(poses, edge_i, edge_j, edge_T, edge_valid, edge_weight, iterations: int,
               robust_delta: float = 0.0, damping: float = 1e-6):
    """(poses (N, 4, 4), per-step cost) after ``iterations`` LM steps of the
    graph, everything taken to float64 on ``poses``' device."""
    tf32_off()
    poses, ei, ej, Z, w0 = _graph(poses, edge_i, edge_j, edge_T, edge_valid, edge_weight)
    dev = poses.device
    n, e = poses.shape[0], ei.shape[0]
    d2 = robust_delta * robust_delta

    def cost(p):
        return _cost(p, ei, ej, Z, w0, robust_delta)

    lam = damping
    costs = []
    rows = torch.arange(6 * e, device=dev).reshape(e, 6)
    for _ in range(iterations):
        w = w0
        if robust_delta > 0:
            rho2 = (_edge_residuals(poses[ei], poses[ej], Z, w0) ** 2).sum(-1)
            w = w0 * d2 / (d2 + rho2)
        c_cur = cost(poses)
        r = _edge_residuals(poses[ei], poses[ej], Z, w).reshape(-1)
        Ji, Jj = _edge_jacobians(poses[ei], poses[ej], Z, w)
        J = torch.zeros(6 * e, 6 * n, dtype=F64, device=dev)
        cols = torch.arange(6, device=dev)
        J[rows[:, :, None], (6 * ei)[:, None, None] + cols] += Ji
        J[rows[:, :, None], (6 * ej)[:, None, None] + cols] += Jj
        J = J[:, 6:]  # pose 0 is fixed
        H = J.T @ J + lam * torch.eye(6 * (n - 1), dtype=F64, device=dev)
        delta = -torch.linalg.solve(H, J.T @ r)
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        step = torch.cat([torch.zeros(6, dtype=F64, device=dev), delta]).reshape(n, 6)
        new = se3.se3_exp(step) @ poses
        c_new = cost(new)
        if bool(torch.isfinite(c_new)) and float(c_new) < float(c_cur):
            poses, lam = new, max(lam / 3.0, 1e-9)
            costs.append(float(c_new))
        else:
            lam = min(lam * 8.0, 1e8)
            costs.append(float(c_cur))
    return poses, costs


# -- rotation averaging, triangulation and gating


def rotation_average(R, edge_i: Sequence[int], edge_j: Sequence[int], edge_R, edge_weight,
                     iters: int = 8, robust_sigma: float = 0.1) -> torch.Tensor:
    """(N, 3, 3) absolute rotations refined so that R_j ~ R_i edge_R_e."""
    tf32_off()
    dev = R.device
    Rw = R.to(F64)
    ei = torch.as_tensor(list(edge_i), device=dev).long()
    ej = torch.as_tensor(list(edge_j), device=dev).long()
    eR = torch.as_tensor(edge_R, dtype=F64, device=dev)
    ew = torch.as_tensor(list(edge_weight), dtype=F64, device=dev)
    n = Rw.shape[0]
    for _ in range(iters):
        v = se3.so3_log(Rw[ei] @ eR @ Rw[ej].transpose(-1, -2))
        w2 = (ew / (1.0 + (v * v).sum(-1) / robust_sigma ** 2)) ** 2
        L = torch.zeros(n, n, dtype=F64, device=dev)
        L.index_put_((ei, ei), w2, accumulate=True)
        L.index_put_((ej, ej), w2, accumulate=True)
        L.index_put_((ei, ej), -w2, accumulate=True)
        L.index_put_((ej, ei), -w2, accumulate=True)
        rhs = torch.zeros(n, 3, dtype=F64, device=dev)
        rhs.index_add_(0, ej, w2[:, None] * v)
        rhs.index_add_(0, ei, -w2[:, None] * v)
        r = torch.linalg.solve(L[1:, 1:] + 1e-9 * torch.eye(n - 1, dtype=F64, device=dev),
                               rhs[1:])
        r = torch.cat([torch.zeros(1, 3, dtype=F64, device=dev), r])
        Rw = se3.so3_exp(r) @ Rw
    return Rw


def triangulate(w2c, obs_cam, obs_lm, obs_uv, n_lm: int) -> torch.Tensor:
    """(L, 3) DLT points of every track from world -> camera poses (C, 4, 4)
    and observations in normalized coordinates."""
    P = w2c.to(F64)[obs_cam.long()][:, :3, :]
    uv = obs_uv.to(F64)
    rows = torch.stack([uv[:, :1] * P[:, 2] - P[:, 0], uv[:, 1:] * P[:, 2] - P[:, 1]], 1)
    M = torch.zeros(n_lm, 4, 4, dtype=F64, device=w2c.device)
    M.index_add_(0, obs_lm.long(), rows.transpose(1, 2) @ rows)
    X = torch.linalg.eigh(M).eigenvectors[..., 0]
    w = X[:, 3]
    w = torch.where(w.abs() < 1e-9, torch.where(w < 0, -1e-9, 1e-9), w)
    return X[:, :3] / w[:, None]


def gate(w2c, pts, obs_cam, obs_lm, obs_uv) -> torch.Tensor:
    """(O,) bool: the observations the next round of bundle adjustment
    uses."""
    T = w2c.to(F64)[obs_cam.long()]
    Xc = (T[:, :3, :3] @ pts.to(F64)[obs_lm.long()][:, :, None])[..., 0] + T[:, :3, 3]
    proj = Xc[:, :2] / torch.clamp(Xc[:, 2:], min=1e-9)
    ok = (Xc[:, 2] > 1e-3) & (torch.linalg.vector_norm(proj - obs_uv.to(F64), dim=1) < 0.02)
    n_ok = torch.bincount(obs_lm.long()[ok], minlength=pts.shape[0])
    return ok & (n_ok >= 2)[obs_lm.long()]
