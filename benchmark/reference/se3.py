"""SO(3) and SE(3) for the plain references of the loop and BA stages, in
PyTorch float64, from the textbook formulas (Barfoot, "State Estimation for
Robotics", 2017, sections 7.1.3 and 7.1.5).

A twist is xi = (rho, phi), translation part first; exp(xi) = [[Exp(phi),
J(phi) rho], [0, 1]] with J the left Jacobian of SO(3), and log is its
inverse (rho = J(phi)^-1 t).  Series stand in below an angle of 1e-4 rad,
where the closed forms lose digits.  Nothing here is differentiated: the
references take Jacobians by hand or by finite differences.
"""

from __future__ import annotations

import torch

SMALL = 1e-4


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) with hat(a) b = a x b."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                        torch.stack([w[..., 2], z, -w[..., 0]], -1),
                        torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _coefficients(theta: torch.Tensor):
    """sin(t) / t, (1 - cos t) / t^2 and (t - sin t) / t^3 at angles (...)."""
    small = theta < SMALL
    t = torch.where(small, torch.ones_like(theta), theta)
    t2 = theta * theta
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(t) / t)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(t)) / (t * t))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0, (t - torch.sin(t)) / (t * t * t))
    return a[..., None, None], b[..., None, None], c[..., None, None]


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    a, b, _ = _coefficients(torch.linalg.vector_norm(phi, dim=-1))
    K = hat(phi)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * K + b * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), the angle in [0, pi].  The angle comes from
    atan2 of the skew part's norm and the trace; within 1e-3 rad of pi, where
    the skew part vanishes, the axis is the column of R + I of largest norm,
    signed by the skew part."""
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2.0  # sin(theta) axis
    s = torch.linalg.vector_norm(w, dim=-1)
    c = (R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    theta = torch.atan2(s, c)
    small = theta < SMALL
    general = w * torch.where(small, 1.0 + theta * theta / 6.0,
                              theta / torch.where(small, torch.ones_like(s), s))[..., None]
    sym = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col = torch.linalg.vector_norm(sym, dim=-2).argmax(-1)
    axis = torch.gather(sym, -1, col[..., None, None].expand(*col.shape, 3, 1))[..., 0]
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    sign = torch.where((axis * w).sum(-1) < 0, -1.0, 1.0)
    near_pi = theta > torch.pi - 1e-3
    return torch.where(near_pi[..., None], axis * (sign * theta)[..., None], general)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    a, b, c = _coefficients(torch.linalg.vector_norm(phi, dim=-1))
    K = hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * (K @ K)
    J = eye + b * K + c * (K @ K)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (J @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6)."""
    phi = so3_log(T[..., :3, :3])
    _, b, c = _coefficients(torch.linalg.vector_norm(phi, dim=-1))
    K = hat(phi)
    J = torch.eye(3, dtype=T.dtype, device=T.device) + b * K + c * (K @ K)
    rho = torch.linalg.solve(J, T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid transforms (..., 4, 4)."""
    out = torch.zeros_like(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def angle(R: torch.Tensor) -> torch.Tensor:
    """Rotation angles (...) of (..., 3, 3), in radians."""
    return torch.linalg.vector_norm(so3_log(R), dim=-1)
