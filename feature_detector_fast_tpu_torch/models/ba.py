"""Bundle adjustment with Schur-complement elimination.

Counterpart of ``feature_detector_fast_tpu.models.ba``: camera poses T_c
(world -> camera, SE(3)), landmarks X_l (world, 3-D), observations (cam,
lm, uv) in normalized image coordinates; minimize
sum ||project(T_c X_l) - uv||^2 with Levenberg damping.

Everything is flat per-observation tensors and segment reductions:

  * per-observation residuals and the (2x6, 2x3) Jacobian blocks come from
    ``torch.func.jacfwd`` under ``torch.func.vmap``, no hand-derived blocks;
  * Hll (3x3 per landmark), b_c and b_l accumulate by segment sums over the
    observations (``scatter_add``; on CUDA its atomics reorder float sums,
    so the card agrees with the CPU to a tolerance, not bit for bit);
  * the reduced camera system S = Hcc - W Hll^-1 W^T is never formed: CG
    runs on its matvec, two segment reductions per application, which take
    ``psum`` / ``psum_lm`` callables for observations sharded over devices;
  * back-substitution recovers the landmark updates from the camera step.

A problem may carry leading batch dimensions on its poses, points, obs_uv
and obs_valid (P independent problems over shared observation indices, as
``slam.estimate_pairs`` refines every pair at once); costs then have the
batch's shape.  Gauge: the first ``n_fixed_cams`` cameras are held fixed.
On the card a global problem given capacities is padded to them with rows
of exact zeros and replays one CUDA graph of the whole call (``optimize``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd, vmap

from ..utils import cuda_graphs
from ..utils.precision import matmul_highest
from . import lie

#: The dtype in which a global (unbatched) problem's normal equations and the
#: conjugate-gradient solve of its reduced camera system are formed, whatever
#: the problem's own dtype (see ``_build_system``).
GLOBAL_SOLVE_DTYPE = torch.float64


class BAProblem(NamedTuple):
    poses: torch.Tensor  # (..., C, 4, 4) world -> camera
    points: torch.Tensor  # (..., L, 3)
    obs_cam: torch.Tensor  # (O,) or (..., O) int
    obs_lm: torch.Tensor  # (O,) or (..., O) int
    obs_uv: torch.Tensor  # (..., O, 2) normalized image coordinates
    obs_valid: torch.Tensor  # (..., O) bool
    n_fixed_cams: int = 1  # leading cameras held constant (gauge)


def _batch(p: BAProblem) -> Tuple[int, ...]:
    return tuple(p.poses.shape[:-3])


def _gather_rows(x: torch.Tensor, idx: torch.Tensor, nb: int) -> torch.Tensor:
    """x (*batch, N, *tail)[idx] -> (*batch, O, *tail); idx (O,) or (*batch, O)."""
    tail = x.shape[nb + 1:]
    shape = x.shape[:nb] + idx.shape[-1:]
    g = idx.reshape(idx.shape + (1,) * len(tail)).expand(shape + tail)
    return torch.gather(x, nb, g)


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, num: int, nb: int = 0) -> torch.Tensor:
    """Sum the observation rows of vals (*batch, O, *tail) into (*batch, num,
    *tail) by idx (O,) or (*batch, O)."""
    tail = vals.shape[nb + 1:]
    g = idx.reshape(idx.shape + (1,) * len(tail)).expand(vals.shape)
    out = vals.new_zeros(vals.shape[:nb] + (num,) + tail)
    return out.scatter_add_(nb, g, vals)


def project(pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World -> camera pose (..., 4, 4), landmark (..., 3) -> normalized (..., 2)."""
    pc = lie.se3_apply(pose, X)
    z = torch.clamp(pc[..., 2], min=1e-6)
    return pc[..., :2] / z[..., None]


def _residual_one(delta_c, delta_l, pose, X, uv):
    """Residual of one observation under local updates (6,), (3,)."""
    T = lie.se3_exp(delta_c) @ pose
    return project(T, X + delta_l) - uv


def _residual_aux(delta_c, delta_l, pose, X, uv):
    r = _residual_one(delta_c, delta_l, pose, X, uv)
    return r, r


def _jacobians(p: BAProblem, robust_delta: float = 0.0):
    """Per-observation residuals r (..., O, 2) and Jacobians Jc (..., O, 2, 6),
    Jl (..., O, 2, 3) at delta = 0, masked by validity.

    ``robust_delta`` > 0 applies Huber IRLS: residual and Jacobians scaled
    by sqrt(w), w = min(1, delta / ||r||)."""
    nb = len(_batch(p))
    poses_o = _gather_rows(p.poses, p.obs_cam, nb)
    pts_o = _gather_rows(p.points, p.obs_lm, nb)
    shape = poses_o.shape[:-2]
    z6 = p.poses.new_zeros(6)
    z3 = p.poses.new_zeros(3)

    def one(pose, X, uv):
        (Jc, Jl), r = jacfwd(_residual_aux, argnums=(0, 1), has_aux=True)(z6, z3, pose, X, uv)
        return r, Jc, Jl

    with lie.FORWARD_AD:  # the threads of parallel.ba_sharded take turns here
        r, Jc, Jl = vmap(one)(poses_o.reshape(-1, 4, 4), pts_o.reshape(-1, 3),
                              p.obs_uv.reshape(-1, 2))
    r = r.reshape(shape + (2,))
    Jc = Jc.reshape(shape + (2, 6))
    Jl = Jl.reshape(shape + (2, 3))
    if robust_delta > 0.0:
        rn = torch.linalg.vector_norm(r, dim=-1)
        sw = torch.sqrt(torch.clamp(robust_delta / torch.clamp(rn, min=1e-12), max=1.0))
        r = r * sw[..., None]
        Jc = Jc * sw[..., None, None]
        Jl = Jl * sw[..., None, None]
    valid = p.obs_valid
    r = torch.where(valid[..., None], r, 0.0)
    Jc = torch.where(valid[..., None, None], Jc, 0.0)
    Jl = torch.where(valid[..., None, None], Jl, 0.0)
    # gauge: zero the Jacobians of fixed cameras
    free = p.obs_cam >= p.n_fixed_cams
    Jc = torch.where(free[..., None, None], Jc, 0.0)
    return r, Jc, Jl


def _inv33(M: torch.Tensor) -> torch.Tensor:
    """Inverse of batched SPD 3x3 matrices by an unrolled Cholesky
    factorization (inv = L^-T L^-1), elementwise arithmetic only, then one
    Newton-Schulz polish X <- X (2I - M X).  Backward-stable in float32,
    where the adjugate form lost ~1e-3 relative accuracy on ill-conditioned
    damped blocks.  Callers pass damped (strictly SPD) blocks."""
    a11, a21, a31 = M[..., 0, 0], M[..., 1, 0], M[..., 2, 0]
    a22, a32, a33 = M[..., 1, 1], M[..., 2, 1], M[..., 2, 2]
    tiny = 1e-30
    l11 = torch.sqrt(torch.clamp(a11, min=tiny))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp(a22 - l21 * l21, min=tiny))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp(a33 - l31 * l31 - l32 * l32, min=tiny))
    # L^-1 (lower triangular)
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    # inv = L^-T L^-1 (symmetric)
    m11 = i11 * i11 + i21 * i21 + i31 * i31
    m12 = i21 * i22 + i31 * i32
    m13 = i31 * i33
    m22 = i22 * i22 + i32 * i32
    m23 = i32 * i33
    m33 = i33 * i33
    X = torch.stack([torch.stack([m11, m12, m13], dim=-1),
                     torch.stack([m12, m22, m23], dim=-1),
                     torch.stack([m13, m23, m33], dim=-1)], dim=-2)
    eye2 = 2.0 * torch.eye(3, dtype=M.dtype, device=M.device)
    return torch.einsum("...ij,...jk->...ik", X, eye2 - torch.einsum("...ij,...jk->...ik", M, X))


class _System(NamedTuple):
    r: torch.Tensor
    Jc: torch.Tensor
    Jl: torch.Tensor
    Hll_inv: torch.Tensor  # (..., L, 3, 3) damped inverse
    b_c: torch.Tensor  # (..., C, 6) = Jc^T r per camera
    b_l: torch.Tensor  # (..., L, 3) = Jl^T r per landmark


def _hll(p: BAProblem, Jl: torch.Tensor) -> torch.Tensor:
    return _segment_sum(torch.einsum("...oij,...oik->...ojk", Jl, Jl), p.obs_lm,
                        p.points.shape[-2], len(_batch(p)))


def _build_system(p: BAProblem, damping, robust_delta: float = 0.0) -> _System:
    r, Jc, Jl = _jacobians(p, robust_delta)
    if not _batch(p):
        # A global problem's normal equations and the conjugate-gradient
        # solve of its reduced camera system in GLOBAL_SOLVE_DTYPE (float64)
        # whatever its dtype: the scale gauge is a null direction damped to
        # 1e-4, and a fixed
        # budget of float32 CG steps on that system amplifies rounding into
        # steps that, over the LM iterations, end up to a quarter above the
        # float64 solve's cost.  A batch of two-camera problems (the pair
        # refit) converges within its budget and stays in its dtype.
        r, Jc, Jl = (t.to(GLOBAL_SOLVE_DTYPE) for t in (r, Jc, Jl))
    nb = len(_batch(p))
    Hll = _hll(p, Jl) + damping * torch.eye(3, dtype=Jl.dtype, device=Jl.device)
    b_c = _segment_sum(torch.einsum("...oij,...oi->...oj", Jc, r), p.obs_cam,
                       p.poses.shape[-3], nb)
    b_l = _segment_sum(torch.einsum("...oij,...oi->...oj", Jl, r), p.obs_lm,
                       p.points.shape[-2], nb)
    return _System(r, Jc, Jl, _inv33(Hll), b_c, b_l)


def _w_times(sys: _System, p: BAProblem, u: torch.Tensor) -> torch.Tensor:
    """W u per camera, Jc^T (Jl u), for a landmark vector u (..., L, 3)."""
    nb = len(_batch(p))
    Jl_u = torch.einsum("...oij,...oj->...oi", sys.Jl, _gather_rows(u, p.obs_lm, nb))
    return _segment_sum(torch.einsum("...oij,...oi->...oj", sys.Jc, Jl_u), p.obs_cam,
                        p.poses.shape[-3], nb)


def _schur_matvec(sys: _System, p: BAProblem, v: torch.Tensor, damping,
                  psum=None, psum_lm=None) -> torch.Tensor:
    """Apply S = Hcc + damping I - W Hll^-1 W^T to v (..., C, 6).  ``psum``
    reduces camera-side partials across all shards; ``psum_lm`` reduces
    landmark-side partials across the shards that replicate a landmark."""
    nb = len(_batch(p))
    psum_lm = psum_lm or psum
    Jc_v = torch.einsum("...oij,...oj->...oi", sys.Jc, _gather_rows(v, p.obs_cam, nb))
    hcc_v = _segment_sum(torch.einsum("...oij,...oi->...oj", sys.Jc, Jc_v), p.obs_cam,
                         p.poses.shape[-3], nb)
    wt_v = _segment_sum(torch.einsum("...oij,...oi->...oj", sys.Jl, Jc_v), p.obs_lm,
                        p.points.shape[-2], nb)
    if psum is not None:
        hcc_v = psum(hcc_v)
        wt_v = psum_lm(wt_v)
    w_u = _w_times(sys, p, torch.einsum("...lij,...lj->...li", sys.Hll_inv, wt_v))
    if psum is not None:
        w_u = psum(w_u)
    return hcc_v + damping * v - w_u


def _cg(matvec, b: torch.Tensor, iters: int) -> torch.Tensor:
    """Conjugate gradient on (..., C, 6) vectors, a fixed ``iters`` steps (no
    early exit), each batch element with its own step sizes.  The pose
    graph's CG solver runs it on its (N, 6) updates, with its damping in
    ``matvec``."""

    def dot(a, c):
        return (a * c).sum((-2, -1), keepdim=True)

    x = torch.zeros_like(b)
    r = b
    p = r
    rs = dot(r, r)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rs / torch.clamp(dot(p, ap), min=1e-20)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = dot(r, r)
        p = r + rs_new / torch.clamp(rs, min=1e-20) * p
        rs = rs_new
    return x


@matmul_highest
def ba_step(p: BAProblem, damping, cg_iters: int, psum=None, psum_lm=None,
            robust_delta: float = 0.0):
    """One damped Gauss-Newton step by Schur elimination.

    Returns (new_poses, new_points, cost_before).  With ``psum``, the
    segment reductions are shard-local partials reduced across devices
    (observations sharded, poses replicated); ``psum_lm`` (default
    ``psum``) reduces the landmark-side partials.  ``robust_delta`` > 0 makes
    it a Huber-IRLS step whose returned cost is the IRLS surrogate."""
    psum_lm = psum_lm or psum
    nb = len(_batch(p))
    sys = _build_system(p, damping, robust_delta)
    b_c = sys.b_c
    b_l = sys.b_l
    if psum is not None:
        b_c = psum(b_c)
        b_l = psum_lm(b_l)
        # Hll must be reduced too: rebuild the inverse from the partials.
        Hll = psum_lm(_hll(p, sys.Jl)) + damping * torch.eye(3, dtype=b_l.dtype,
                                                             device=b_l.device)
        sys = sys._replace(Hll_inv=_inv33(Hll))

    # reduced rhs: -(b_c - W Hll^-1 b_l)
    w_u = _w_times(sys, p, torch.einsum("...lij,...lj->...li", sys.Hll_inv, b_l))
    if psum is not None:
        w_u = psum(w_u)
    rhs = -(b_c - w_u)

    delta_c = _cg(lambda v: _schur_matvec(sys, p, v, damping, psum, psum_lm), rhs, cg_iters)
    cam_free = torch.arange(p.poses.shape[-3], device=p.poses.device) >= p.n_fixed_cams
    delta_c = torch.where(cam_free[:, None], delta_c, 0.0)

    # back-substitute landmarks: delta_l = -Hll^-1 (b_l + W^T delta_c)
    Jc_dc = torch.einsum("...oij,...oj->...oi", sys.Jc, _gather_rows(delta_c, p.obs_cam, nb))
    wt_dc = _segment_sum(torch.einsum("...oij,...oi->...oj", sys.Jl, Jc_dc), p.obs_lm,
                         p.points.shape[-2], nb)
    if psum is not None:
        wt_dc = psum_lm(wt_dc)
    delta_l = -torch.einsum("...lij,...lj->...li", sys.Hll_inv, b_l + wt_dc)

    new_poses = lie.se3_exp(delta_c.to(p.poses.dtype)) @ p.poses
    new_points = p.points + delta_l.to(p.points.dtype)
    cost = (sys.r * sys.r).sum((-2, -1)).to(p.poses.dtype)
    if psum is not None:
        cost = psum(cost)
    return new_poses, new_points, cost


def _residuals(p: BAProblem) -> torch.Tensor:
    """Validity-masked residuals (..., O, 2) without the Jacobian passes."""
    nb = len(_batch(p))
    poses_o = _gather_rows(p.poses, p.obs_cam, nb)
    pts_o = _gather_rows(p.points, p.obs_lm, nb)
    r = project(poses_o, pts_o) - p.obs_uv
    return torch.where(p.obs_valid[..., None], r, 0.0)


@matmul_highest
def total_cost(p: BAProblem, robust_delta: float = 0.0) -> torch.Tensor:
    """Objective value per problem: the plain sum of squares, or the Huber
    objective when ``robust_delta`` > 0 (rho(r) = r^2 for ||r|| < delta,
    else delta (2 ||r|| - delta)), the cost the IRLS steps descend."""
    r = _residuals(p)
    if robust_delta <= 0.0:
        return (r * r).sum((-2, -1))
    rn2 = (r * r).sum(-1)
    rn = torch.sqrt(torch.clamp(rn2, min=1e-24))
    rho = torch.where(rn < robust_delta, rn2, robust_delta * (2.0 * rn - robust_delta))
    return torch.where(p.obs_valid, rho, 0.0).sum(-1)


@matmul_highest
def optimize(p: BAProblem, iterations: int = 10, cg_iters: int = 30, damping: float = 1e-4,
             robust_delta: float = 0.0, counts=None, obs_capacity: Optional[int] = None,
             lm_capacity: Optional[int] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """LM-damped BA.  Returns (poses, points, per-iteration cost
    (iterations, ...)).  A step that raises a problem's cost is rejected for
    that problem (``torch.where``, no host check).  ``robust_delta`` > 0
    switches to Huber-IRLS steps, accepted on the true Huber objective.

    A global (unbatched) problem on CUDA tensors given ``obs_capacity`` or
    ``lm_capacity`` takes the graph path: padded to that many observations
    and landmarks (``_pad``: rows of exact zeros), so that problems of one
    camera count share a CUDA-graph key (``_graph_key``), it replays one
    CUDA graph of all its steps where its key is that of the device's
    graph, and captures that graph where it is the key's
    ``cuda_graphs.CAPTURE_AT``-th call in a row on the device; the returned
    shapes are those of the unpadded call.  Any other call runs eagerly and
    unpadded, as does every batched problem, whatever its capacities.  A
    capacity below the problem's count raises ValueError.

    ``counts``, a ``tracing.span`` handle, gets ``solves`` (1), ``lm_steps``
    (``iterations``) and ``cg_steps`` (``iterations * cg_iters``), and for a
    global problem ``graph_replays`` (1 where a replay answered the call,
    the capturing one included, else 0) and ``graph_captures`` (1 where the
    call captured) while a profiler records, host integers with no device
    work; the caller counts ``lm_accepted`` from the returned costs
    (``lowered``) with its own fetch of the result."""
    if counts:
        counts.add("solves")
        counts.add("lm_steps", iterations)
        counts.add("cg_steps", iterations * cg_iters)
    args = (iterations, cg_iters, damping, robust_delta)
    if _batch(p):
        return _lm(p, *args)
    capacities = _capacities(p, obs_capacity, lm_capacity)
    replayed = None
    if (obs_capacity is not None or lm_capacity is not None) and _on_card(p):
        q = _pad(p, *capacities)
        replayed = _GRAPHS.run(_graph_key(q, args), q[:6], lambda dev: _Graph(q, args, dev))
    (poses, points, costs), captured = replayed or (_lm(p, *args), False)
    if counts:
        counts.add("graph_replays", int(replayed is not None))
        counts.add("graph_captures", int(captured))
    return poses, points[:p.points.shape[0]], costs


def _lm(p: BAProblem, iterations: int, cg_iters: int, damping: float, robust_delta: float
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``optimize``'s LM steps: (poses, points, per-iteration cost)."""
    poses, points = p.poses, p.points
    costs = []
    for _ in range(iterations):
        pp = p._replace(poses=poses, points=points)
        # ba_step's cost is the residuals it already evaluated; under IRLS
        # the acceptance test uses the Huber objective on both sides.
        new_poses, new_points, c_old = ba_step(pp, damping, cg_iters, robust_delta=robust_delta)
        if robust_delta > 0.0:
            c_old = total_cost(pp, robust_delta)
        c_new = total_cost(p._replace(poses=new_poses, points=new_points), robust_delta)
        better = c_new < c_old
        poses = torch.where(better[..., None, None, None], new_poses, poses)
        points = torch.where(better[..., None, None], new_points, points)
        costs.append(torch.minimum(c_new, c_old))
    return poses, points, torch.stack(costs)


def _capacities(p: BAProblem, obs_capacity: Optional[int], lm_capacity: Optional[int]
                ) -> Tuple[int, int]:
    """(observations, landmarks) a global problem ``p`` pads to: each
    capacity, or the count where it is None.  Raises ValueError where a
    capacity is below the problem's count."""
    n_obs, n_lm = p.obs_lm.shape[0], p.points.shape[0]
    obs_capacity = n_obs if obs_capacity is None else obs_capacity
    lm_capacity = n_lm if lm_capacity is None else lm_capacity
    for name, cap, n in (("obs_capacity", obs_capacity, n_obs), ("lm_capacity", lm_capacity, n_lm)):
        if cap < n:
            raise ValueError(f"{name} {cap} is below the problem's {n}")
    return obs_capacity, lm_capacity


def _pad(p: BAProblem, obs_capacity: int, lm_capacity: int) -> BAProblem:
    """Global problem ``p`` with its observations padded to ``obs_capacity``
    and its landmarks to ``lm_capacity`` (at least its counts:
    ``_capacities``).  A padded landmark sits at the origin and has no valid
    observation: its Hll is ``damping`` I and its b_l 0, so its update is
    exactly 0.  A padded observation is invalid, with uv 0, so
    ``_jacobians`` zeroes its residual and Jacobian rows; the k-th observes
    camera k mod C and landmark (L + k) mod ``lm_capacity``, the padded
    landmarks first, so that the zeros it adds spread over the segment
    sums' atomics."""
    n_obs, n_lm = p.obs_lm.shape[0], p.points.shape[0]
    if (obs_capacity, lm_capacity) == (n_obs, n_lm):
        return p
    k = torch.arange(obs_capacity - n_obs, device=p.obs_lm.device)
    return p._replace(
        points=torch.cat([p.points, p.points.new_zeros((lm_capacity - n_lm, 3))]),
        obs_cam=torch.cat([p.obs_cam, (k % p.poses.shape[0]).to(p.obs_cam.dtype)]),
        obs_lm=torch.cat([p.obs_lm, ((n_lm + k) % lm_capacity).to(p.obs_lm.dtype)]),
        obs_uv=torch.cat([p.obs_uv, p.obs_uv.new_zeros((obs_capacity - n_obs, 2))]),
        obs_valid=torch.cat([p.obs_valid, p.obs_valid.new_zeros(obs_capacity - n_obs)]))


def _on_card(p: BAProblem) -> bool:
    """Whether every tensor of ``p`` is on a CUDA device (the graph path)."""
    return all(t.is_cuda for t in p[:6])


def _graph_key(p: BAProblem, args: tuple) -> tuple:
    """A global call's CUDA-graph key: its device, each tensor's device,
    dtype and (padded) shape, ``optimize``'s LM arguments and the fixed
    cameras."""
    return ((p.poses.device,) + tuple((t.device, t.dtype, t.shape) for t in p[:6]) + args
            + (p.n_fixed_cams,))


class _Graph(cuda_graphs.Graph):
    """One ``_lm`` call as a CUDA graph: its static outputs are the poses,
    the points and the costs."""

    def __init__(self, p: BAProblem, args: tuple, dev: cuda_graphs.Device):
        def run(inputs: tuple, warm: bool):
            return _lm(BAProblem(*inputs, p.n_fixed_cams), 1 if warm else args[0], *args[1:])

        super().__init__(run, p[:6], dev)


#: ``optimize``'s CUDA graphs, one a device, apart from the pose graph's:
#: the two solvers' calls alternate in a sequence.
_GRAPHS = cuda_graphs.Graphs()


def lowered(costs: torch.Tensor, cost0: torch.Tensor) -> torch.Tensor:
    """Which of ``optimize``'s steps lowered its returned cost: (iterations,
    ...) bool, step k against step k - 1's cost and the first against
    ``cost0``, the problem's cost at the start (``total_cost``).  On the
    Huber route these are the accepted steps exactly: both sides of its
    acceptance test are ``total_cost`` values, and a rejected step returns
    the cost it kept."""
    return costs < torch.cat([cost0[None], costs[:-1]])
