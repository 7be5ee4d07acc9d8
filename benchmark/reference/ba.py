"""Plain reference of the SLAM cell's bundle adjustment, in PyTorch float64
on whatever device the problem is given on: Huber-IRLS Levenberg-Marquardt
with the Schur complement (Triggs et al., "Bundle Adjustment - A Modern
Synthesis", 2000, sections 6 and 7), as the port documents it
(``models/ba.py``); it imports nothing of the port.

A problem is world -> camera poses (C, 4, 4), points (L, 3), observations
(camera, point, uv in normalized coordinates) and their validity.  One
step: residuals r = project(T X) - uv with the depth clamped at 1e-6; IRLS
weights sqrt(min(1, delta / |r|)) on each observation's residual and
Jacobians; Jacobians by hand for a left increment T <- exp(d) T (d = (rho,
phi)) and X <- X + e; damping lambda added to the camera and point blocks;
the points eliminated (S = Hcc + lambda I - W (Hll + lambda I)^-1 W^T);
the first ``n_fixed`` cameras held (zero Jacobians, zero step).  The step
is kept where it lowers the Huber cost (|r|^2 below delta, delta (2 |r| -
delta) above), else the state stays; lambda is fixed.

The reduced camera system is solved directly (``torch.linalg.solve``) or,
with ``cg_iters``, by that many conjugate-gradient steps from zero with no
early exit, the port's fixed budget.  The SLAM cell compares the program
with the latter: the port's 40 steps stop short of the exact step, and its
cost after 20 LM steps reads 1.1-1.5x the direct solve's on the cell's
sequences, which would hide a solve that left out half its iterations
(PERF.md section 2).  Departures from the port: S and W are formed densely,
where the port applies them matrix-free; the point blocks are inverted by
``torch.linalg.inv``, where the port unrolls a Cholesky factorization.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from . import se3
from .slam import F64, tf32_off


class Problem(NamedTuple):
    w2c: torch.Tensor  # (C, 4, 4)
    points: torch.Tensor  # (L, 3)
    obs_cam: torch.Tensor  # (O,)
    obs_lm: torch.Tensor  # (O,)
    obs_uv: torch.Tensor  # (O, 2)
    valid: torch.Tensor  # (O,) bool

    def f64(self) -> "Problem":
        dev = self.w2c.device
        return Problem(self.w2c.to(F64), self.points.to(dev, F64), self.obs_cam.to(dev).long(),
                       self.obs_lm.to(dev).long(), self.obs_uv.to(dev, F64),
                       self.valid.to(dev).bool())


def residuals(p: Problem) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r (O, 2), camera-frame points (O, 3)); r is 0 where invalid."""
    T = p.w2c[p.obs_cam]
    pc = (T[:, :3, :3] @ p.points[p.obs_lm][:, :, None])[..., 0] + T[:, :3, 3]
    z = torch.clamp(pc[:, 2:], min=1e-6)
    r = pc[:, :2] / z - p.obs_uv
    return torch.where(p.valid[:, None], r, 0.0), pc


def huber_cost(p: Problem, delta: float) -> torch.Tensor:
    """The Huber objective (the plain sum of squares with ``delta`` 0)."""
    r, _ = residuals(p)
    rn2 = (r * r).sum(-1)
    if delta <= 0:
        return rn2.sum()
    rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
    rho = torch.where(rn < delta, rn2, delta * (2.0 * rn - delta))
    return torch.where(p.valid, rho, 0.0).sum()


def _linearize(p: Problem, delta: float, n_fixed: int):
    """IRLS-weighted r (O, 2), Jc (O, 2, 6), Jl (O, 2, 3)."""
    r, pc = residuals(p)
    x, y, zraw = pc[:, 0], pc[:, 1], pc[:, 2]
    z = torch.clamp(zraw, min=1e-6)
    dz = (zraw >= 1e-6).to(F64)  # the clamp passes no slope below it
    zero = torch.zeros_like(z)
    Jp = torch.stack([torch.stack([1 / z, zero, -x / z ** 2 * dz], -1),
                      torch.stack([zero, 1 / z, -y / z ** 2 * dz], -1)], -2)  # (O, 2, 3)
    eye = torch.eye(3, dtype=F64, device=pc.device).expand(pc.shape[0], 3, 3)
    Jc = Jp @ torch.cat([eye, -se3.hat(pc)], -1)
    Jl = Jp @ p.w2c[p.obs_cam][:, :3, :3]
    if delta > 0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        sw = torch.sqrt(torch.clamp(delta / torch.clamp(rn, min=1e-12), max=1.0))
        r, Jc, Jl = r * sw[:, None], Jc * sw[:, None, None], Jl * sw[:, None, None]
    v = p.valid[:, None, None]
    Jc = torch.where(v & (p.obs_cam >= n_fixed)[:, None, None], Jc, 0.0)
    return torch.where(p.valid[:, None], r, 0.0), Jc, torch.where(v, Jl, 0.0)


def _cg(S: torch.Tensor, b: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` conjugate-gradient steps on S x = b from x = 0, with no
    early exit (the step sizes' denominators held above 1e-20)."""
    x = torch.zeros_like(b)
    r = b
    d = r
    rs = r @ r
    for _ in range(iters):
        Sd = S @ d
        alpha = rs / torch.clamp(d @ Sd, min=1e-20)
        x = x + alpha * d
        r = r - alpha * Sd
        rs_new = r @ r
        d = r + rs_new / torch.clamp(rs, min=1e-20) * d
        rs = rs_new
    return x


def step(p: Problem, damping: float, delta: float, n_fixed: int = 1,
         cg_iters: Optional[int] = None) -> Problem:
    """One damped Gauss-Newton step: the reduced camera system solved
    directly, or with ``cg_iters`` by that many conjugate-gradient steps."""
    c, l = p.w2c.shape[0], p.points.shape[0]
    dev = p.w2c.device
    r, Jc, Jl = _linearize(p, delta, n_fixed)
    eye3 = torch.eye(3, dtype=F64, device=dev)
    Hll = torch.zeros(l, 3, 3, dtype=F64, device=dev).index_add_(
        0, p.obs_lm, Jl.transpose(1, 2) @ Jl) + damping * eye3
    Hll_inv = torch.linalg.inv(Hll)
    Hcc = torch.zeros(c, 6, 6, dtype=F64, device=dev).index_add_(
        0, p.obs_cam, Jc.transpose(1, 2) @ Jc)
    b_c = torch.zeros(c, 6, dtype=F64, device=dev).index_add_(
        0, p.obs_cam, (Jc.transpose(1, 2) @ r[:, :, None])[..., 0])
    b_l = torch.zeros(l, 3, dtype=F64, device=dev).index_add_(
        0, p.obs_lm, (Jl.transpose(1, 2) @ r[:, :, None])[..., 0])
    W = torch.zeros(c * l, 6, 3, dtype=F64, device=dev).index_add_(
        0, p.obs_cam * l + p.obs_lm, Jc.transpose(1, 2) @ Jl).reshape(c, l, 6, 3)
    WH = W @ Hll_inv  # (C, L, 6, 3)
    flat = W.permute(0, 2, 1, 3).reshape(6 * c, 3 * l)
    S = -(WH.permute(0, 2, 1, 3).reshape(6 * c, 3 * l) @ flat.T)
    S += torch.block_diag(*Hcc) + damping * torch.eye(6 * c, dtype=F64, device=dev)
    rhs = -(b_c - torch.einsum("clik,lk->ci", WH, b_l))
    if cg_iters is None:
        dc = torch.linalg.solve(S, rhs.reshape(-1)).reshape(c, 6)
    else:
        dc = _cg(S, rhs.reshape(-1), cg_iters).reshape(c, 6)
    dc[:n_fixed] = 0.0
    dl = -(Hll_inv @ (b_l + torch.einsum("clij,ci->lj", W, dc))[:, :, None])[..., 0]
    return p._replace(w2c=se3.se3_exp(dc) @ p.w2c, points=p.points + dl)


def solve(p: Problem, iterations: int, damping: float = 1e-4, delta: float = 0.01,
          n_fixed: int = 1, cg_iters: Optional[int] = None) -> Tuple[Problem, List[float]]:
    """``iterations`` LM steps from ``p`` (taken to float64): the problem at
    the last kept state, and the cost after each step."""
    tf32_off()
    p = p.f64()
    cost = float(huber_cost(p, delta))
    costs = []
    for _ in range(iterations):
        q = step(p, damping, delta, n_fixed, cg_iters)
        c_new = float(huber_cost(q, delta))
        if c_new < cost:
            p, cost = q, c_new
        costs.append(cost)
    return p, costs
