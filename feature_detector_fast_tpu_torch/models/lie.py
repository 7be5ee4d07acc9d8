"""SO(3) / SE(3) Lie group operations, batched over leading dimensions.

Counterpart of ``feature_detector_fast_tpu.models.lie``.  Every function
follows its input's dtype and device, works under ``torch.func``
transforms (vmap, jacfwd, jvp) and autograd, and takes any leading batch
shape.  Small-angle branches use Taylor series selected with
``torch.where``, and every branch is finite everywhere, so gradients stay
finite at zero (an unselected branch with an infinite derivative still
poisons the gradient with 0 * inf = NaN).

Conventions: rotations are 3x3 matrices; se(3) tangent vectors are
xi = (rho, phi) with the translation part first; T = [[R, t], [0, 1]] acts
as T(p) = R p + t.
"""

from __future__ import annotations

import threading

import torch

_EPS = 1e-8

#: Forward-mode AD levels are process-wide in torch, not per thread: two
#: threads in ``jacfwd`` / ``jvp`` at once free each other's level.  Every
#: forward-mode transform of the port (``ba._jacobians``, ``posegraph``'s
#: dense Jacobian and CG products) runs under this lock; re-entrant, so a
#: caller that already holds it cannot deadlock.
FORWARD_AD = threading.RLock()


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device).expand(like.shape)


def _safe_theta(w: torch.Tensor):
    """(theta2, theta_safe, small) with a gradient-safe sqrt: theta_safe is 1
    where theta is tiny (the Taylor branch is used there), so no NaN
    gradient comes from sqrt at zero."""
    theta2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    theta_safe = torch.sqrt(torch.where(small, 1.0, theta2))
    return theta2, theta_safe, small


def _sinc(theta2, theta, small):
    """sin(theta) / theta with a Taylor fallback."""
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)


def _cosc(theta2, theta, small):
    """(1 - cos(theta)) / theta^2 with a Taylor fallback; the denominator is
    the guarded theta (1 where small), never the raw theta2."""
    return torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / (theta * theta))


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta2, theta, small = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    return _eye3(K) + _sinc(theta2, theta, small) * K + _cosc(theta2, theta, small) * K2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    theta comes from atan2(|skew|, (tr - 1) / 2) with a guarded sqrt, so no
    arccos at 1 or norm at 0 appears in any branch.  Near pi the skew part
    vanishes: the axis magnitudes come from the diagonal, their relative
    signs from the symmetric off-diagonals anchored at the largest
    component, and the global sign from the skew part while sin(theta) is
    still nonzero (at exactly pi both signs give the same rotation)."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    w = vee(R - R.transpose(-1, -2)) / 2.0  # = sin(theta) * axis
    s2 = (w * w).sum(-1)  # = sin(theta)^2
    small = s2 < 1e-12
    sin_safe = torch.sqrt(torch.where(small, 1.0, s2))
    theta = torch.atan2(sin_safe, cos)
    scale = torch.where(small, 1.0 + s2 / 6.0, theta / sin_safe)
    general = w * scale[..., None]

    near_pi = cos < -0.999
    theta_pi = torch.arccos(torch.clamp(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    diag = R.diagonal(dim1=-2, dim2=-1)
    axis_sq = torch.clamp((diag - cos[..., None]) / (1.0 - cos[..., None] + _EPS), min=0.0)
    axis_abs = torch.sqrt(axis_sq + _EPS)
    sym = (R + R.transpose(-1, -2)) / 2.0
    k = torch.argmax(axis_sq, dim=-1)
    row_k = torch.gather(sym, -2, k[..., None, None].expand(*k.shape, 1, 3))[..., 0, :]
    # one_hot would check its input on the host: compare with 0..2 instead.
    is_k = k[..., None] == torch.arange(3, device=R.device)
    rel = torch.where(is_k, 1.0, torch.sign(torch.where(row_k.abs() > 0, row_k, 1.0)))
    axis = axis_abs * rel
    dot_w = (w * axis).sum(-1, keepdim=True)
    g = torch.sign(torch.where(dot_w.abs() > 1e-6, dot_w, 1.0))
    pi_branch = axis * g * theta_pi[..., None]
    return torch.where(near_pi[..., None], pi_branch, general)


def _bottom(top: torch.Tensor) -> torch.Tensor:
    # built on the device (a host tensor would be a synchronizing copy)
    row = torch.eye(4, dtype=top.dtype, device=top.device)[3]
    return row.expand(top[..., :1, :].shape)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2, theta, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    eye = _eye3(K)
    R = eye + _sinc(theta2, theta, small) * K + _cosc(theta2, theta, small) * K2
    # Left Jacobian V
    c3 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (theta * theta * theta))
    V = eye + _cosc(theta2, theta, small) * K + c3 * K2
    t = (V @ rho[..., None])[..., 0]
    top = torch.cat([R, t[..., None]], dim=-1)
    return torch.cat([top, _bottom(top)], dim=-2)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2, theta, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    # V^-1 = I - K/2 + c K^2,  c = (1 - theta cot(theta/2) / 2) / theta^2
    half = theta / 2.0
    cot_term = half * torch.cos(half) / torch.sin(torch.where(small, 1.0, half))
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / (theta * theta))
    Vinv = _eye3(K) - K / 2.0 + c * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])
    top = torch.cat([Rt, ti], dim=-1)
    return torch.cat([top, _bottom(top)], dim=-2)


def se3_compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def se3_apply(T: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)
