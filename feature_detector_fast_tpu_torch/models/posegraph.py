"""Pose-graph optimization on SE(3): Gauss-Newton with adaptive LM.

Counterpart of ``feature_detector_fast_tpu.models.posegraph``.  N absolute
poses are constrained by relative-pose measurements on edges; the optimizer
minimizes sum_e || log(Z_e^-1 T_i^-1 T_j) ||^2_w.

  * fixed-capacity edge tensors with validity bits;
  * residuals and Jacobians by automatic differentiation of the local
    parameterization T_i <- exp(delta_i) T_i at delta = 0;
  * two solvers: dense normal equations (formed and solved in float64 by
    one ``torch.linalg.solve_ex``, which leaves its error check on the
    device) with a forward-mode Jacobian, and matrix-free conjugate gradient on jvp / vjp products;
  * the gauge is fixed by masking pose 0's update;
  * acceptance and the LM schedule are ``torch.where`` on the device: no
    host check inside the iterations;
  * on a CUDA device a call replays one CUDA graph of all its iterations
    where its key (the inputs' devices, dtypes and shapes, and every
    argument but ``counts``) is that of the device's graph, and captures
    that graph where it is the key's ``CAPTURE_AT``-th call in a row on the
    device; any other call runs eagerly.  A device keeps one graph.  CPU
    tensors always run eagerly.  An ``edge_capacity`` pads the edges to a
    fixed count first, so that graphs with different edge counts share a
    key.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, jvp, vjp

from ..utils import cuda_graphs
from ..utils.precision import matmul_highest
from . import ba, lie

#: The dtype in which the dense solver forms and solves its normal equations,
#: whatever the poses' dtype (see ``_steps``).
SOLVE_DTYPE = torch.float64


class PoseGraph(NamedTuple):
    """Fixed-capacity pose-graph problem."""

    poses: torch.Tensor  # (N, 4, 4) world_T_body estimates
    edge_i: torch.Tensor  # (E,) int source pose index
    edge_j: torch.Tensor  # (E,) int target pose index
    edge_T: torch.Tensor  # (E, 4, 4) measured T_i^-1 T_j
    edge_valid: torch.Tensor  # (E,) bool
    edge_weight: torch.Tensor  # (E,) float residual weight (sqrt information)


def edge_residuals(poses: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """(E, 6) weighted residuals log(Z^-1 T_i^-1 T_j)."""
    Ti = poses[g.edge_i]
    Tj = poses[g.edge_j]
    rel = lie.se3_inverse(g.edge_T) @ (lie.se3_inverse(Ti) @ Tj)
    r = lie.se3_log(rel)
    w = torch.where(g.edge_valid, g.edge_weight, 0.0)
    return r * w[:, None]


def _residual_of_delta(delta: torch.Tensor, g: PoseGraph) -> torch.Tensor:
    """Residual vector as a function of the stacked local update (N, 6);
    pose 0 is gauge-fixed (its delta is ignored)."""
    keep = (torch.arange(delta.shape[0], device=delta.device) > 0)[:, None]
    poses = lie.se3_exp(torch.where(keep, delta, 0.0)) @ g.poses
    return edge_residuals(poses, g).reshape(-1)


def _normal_system(g: PoseGraph):
    """(JtJ matvec, Jtr, r2) by jvp / vjp at delta = 0, matrix-free."""
    zero = g.poses.new_zeros((g.poses.shape[0], 6))

    def f(d):
        return _residual_of_delta(d, g)

    r0, pullback = vjp(f, zero)

    def jtj_v(v):
        with lie.FORWARD_AD:
            _, jv = jvp(f, (zero,), (v,))
        return pullback(jv)[0]

    return jtj_v, pullback(r0)[0], (r0 * r0).sum()


CAPTURE_AT = cuda_graphs.CAPTURE_AT


def _pad_edges(g: PoseGraph, capacity: Optional[int]) -> PoseGraph:
    """``g`` with its edges padded to ``capacity`` slots (None: as it is).
    Each padded slot repeats edge 0's ends and measurement, invalid and of
    weight 0, so its residual and Jacobian rows are a finite value times 0:
    exactly zero.  (An identity measurement could give a NaN tangent from
    ``se3_log`` at zero angle, and NaN times 0 is NaN.)  Raises ValueError
    where ``capacity`` is below the edge count."""
    e = g.edge_i.shape[0]
    if capacity is None or capacity == e:
        return g
    if capacity < e:
        raise ValueError(f"edge_capacity {capacity} is below the graph's {e} edges")

    def pad(t: torch.Tensor, fill=None) -> torch.Tensor:
        head = t[:1] if fill is None else torch.full_like(t[:1], fill)
        return torch.cat([t, head.expand(capacity - e, *t.shape[1:])])

    return g._replace(edge_i=pad(g.edge_i), edge_j=pad(g.edge_j), edge_T=pad(g.edge_T),
                      edge_valid=pad(g.edge_valid, False), edge_weight=pad(g.edge_weight, 0.0))


@matmul_highest
def optimize(g: PoseGraph, iterations: int = 10, solver: str = "dense", cg_iters: int = 50,
             damping: float = 1e-6, robust_delta: float = 0.0, counts=None,
             edge_capacity: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levenberg-style Gauss-Newton.  Returns (poses, per-iteration cost).

    ``robust_delta`` > 0 enables robust IRLS: each iteration reweights edge
    e by the Cauchy weight s = delta^2 / (delta^2 + ||r_e||^2) of its current
    residual, while acceptance guards the Geman-McClure cost
    rho^2 delta^2 / (delta^2 + rho^2), so every accepted step lowers it (the
    JAX package's form, posegraph.py:150-160).

    Damping is adaptive LM: ``damping`` seeds lambda; a rejected step
    multiplies it by 8, an accepted one divides it by 3.  Acceptance also
    needs a finite new cost.  The dense solver's Jacobian is forward mode:
    reverse mode through se3_log near pi gave NaN in the JAX package.

    On CUDA tensors the ``CAPTURE_AT``-th call in a row of a key (the
    inputs' devices, dtypes and shapes and the other arguments) on a device
    captures a CUDA graph of the whole call, in place of the device's graph,
    and replays it; later calls of that key replay it: their inputs are
    copied into the graph's static buffers and clones of its outputs
    returned.  A capture that fails raises; a device-wide synchronisation
    (``torch.cuda.synchronize``) by another thread while it records is
    such a failure.

    ``edge_capacity``, where given, pads the edges to that many slots
    before the key is taken (``_pad_edges``): graphs of one pose count whose
    edge counts differ then share a key, and the padded slots add rows of
    zeros.  The returned shapes are those of the unpadded call.

    ``counts``, a ``tracing.span`` handle, gets ``calls``, ``graph_replays``
    (calls answered by a replay, the capturing one included),
    ``graph_captures``, and ``steps`` (iterations), ``steps_accepted``,
    ``edges`` (the graph's) and ``edge_slots`` (after padding) while a
    profiler records: one more kernel and one copy a call then, nothing
    otherwise."""
    edges = g.edge_i.shape[0]
    g = _pad_edges(g, edge_capacity)
    args = (iterations, solver, cg_iters, damping, robust_delta)
    replayed = None
    if all(t.is_cuda for t in g):
        replayed = _GRAPHS.replay(_graph_key(g, args), g, args)
    if replayed is None:
        poses, costs, accepted = _steps(g, *args, flags=bool(counts))
    else:
        (poses, costs, accepted), captured = replayed
    if counts is not None:
        counts.add("calls")
        if replayed is not None:
            counts.add("graph_replays")
            if captured:
                counts.add("graph_captures")
    if counts:
        counts.add("steps", iterations)
        counts.add("steps_accepted", int(accepted.cpu().sum()))
        counts.add("edges", edges)
        counts.add("edge_slots", g.edge_i.shape[0])
    return poses, costs


def _steps(g: PoseGraph, iterations: int, solver: str, cg_iters: int, damping: float,
           robust_delta: float, flags: bool
           ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """``optimize``'s iterations: (poses, per-iteration cost, and with
    ``flags`` each step's acceptance, else None)."""
    n = g.poses.shape[0]
    d2 = robust_delta * robust_delta

    def robust_cost(poses):
        r = edge_residuals(poses, g)
        rho2 = (r * r).sum(-1)
        return (d2 * rho2 / (d2 + rho2)).sum()

    poses = g.poses
    lam = torch.full((), damping, dtype=g.poses.dtype, device=g.poses.device)
    costs = []
    accepted = [] if flags else None
    for _ in range(iterations):
        gg = g._replace(poses=poses)
        if robust_delta > 0.0:
            # One evaluation gives both the IRLS weights and the current
            # robust cost (gg still carries g's weights here).
            r_cur = edge_residuals(poses, gg)
            rho2 = (r_cur * r_cur).sum(-1)
            r2_cur = (d2 * rho2 / (d2 + rho2)).sum()
            gg = gg._replace(edge_weight=g.edge_weight * (d2 / (d2 + rho2)))
        if solver == "dense":
            zero = poses.new_zeros((n, 6))
            r0 = _residual_of_delta(zero, gg)
            with lie.FORWARD_AD:
                J = jacfwd(lambda d: _residual_of_delta(d, gg))(zero)
            J = J.reshape(r0.numel(), n * 6)
            r2 = (r0 * r0).sum()
            # The normal equations in SOLVE_DTYPE (float64) whatever the
            # poses' dtype: a loop graph's J^T J reaches a condition of ~1e11,
            # past which a float32 product and solve return its weak modes'
            # steps as rounding noise, and the robust steps wander off the
            # optimum.
            Jd = J.to(SOLVE_DTYPE)
            H = Jd.T @ Jd + lam.to(SOLVE_DTYPE) * torch.eye(n * 6, dtype=SOLVE_DTYPE,
                                                            device=poses.device)
            delta = -torch.linalg.solve_ex(H, Jd.T @ r0.to(SOLVE_DTYPE))[0].to(poses.dtype)
            delta = delta.reshape(n, 6)
        else:  # "cg"
            jtj_v, jtr, r2 = _normal_system(gg)
            delta = -ba._cg(lambda v: jtj_v(v) + lam * v, jtr, cg_iters)
        if robust_delta > 0.0:
            r2 = r2_cur
        delta[0] = 0.0
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        new_poses = lie.se3_exp(delta) @ poses
        if robust_delta > 0.0:
            new_r2 = robust_cost(new_poses)
        else:
            new_r = edge_residuals(new_poses, g)
            new_r2 = (new_r * new_r).sum()
        better = torch.isfinite(new_r2) & (new_r2 < r2)
        poses = torch.where(better, new_poses, poses)
        lam = torch.where(better, torch.clamp(lam / 3.0, min=1e-9), torch.clamp(lam * 8.0, max=1e8))
        costs.append(torch.where(better, new_r2, r2))
        if accepted is not None:
            accepted.append(better)
    return poses, torch.stack(costs), None if accepted is None else torch.stack(accepted)


def _graph_key(g: PoseGraph, args: tuple) -> tuple:
    """A call's CUDA-graph key: its device, each input's device, dtype and
    shape, and ``optimize``'s other arguments but ``counts``."""
    return (g.poses.device,) + tuple((t.device, t.dtype, t.shape) for t in g) + args


_Device = cuda_graphs.Device


class _Graph(cuda_graphs.Graph):
    """One ``_steps`` call as a CUDA graph: its static outputs are the
    poses, costs and acceptance flags."""

    def __init__(self, g: PoseGraph, args: tuple, dev: cuda_graphs.Device):
        def run(inputs: tuple, warm: bool):
            return _steps(PoseGraph(*inputs), 1 if warm else args[0], *args[1:], flags=True)

        super().__init__(run, g, dev)


class _Graphs(cuda_graphs.Graphs):
    """``optimize``'s CUDA graphs, one a device."""

    def new_device(self, device: torch.device) -> cuda_graphs.Device:
        return _Device(device)

    def replay(self, key: tuple, g: PoseGraph, args: tuple):
        """(outputs, whether this call captured) of the call's replay, or
        None where the call runs eagerly (``cuda_graphs.Graphs.run``)."""
        return self.run(key, g, lambda dev: _Graph(g, args, dev))


_GRAPHS = _Graphs()


@matmul_highest
def rotation_average(R: torch.Tensor, edge_i, edge_j, edge_R: torch.Tensor, edge_weight,
                     iters: int = 8, robust_sigma: float = 0.1) -> torch.Tensor:
    """Global rotation averaging: refine absolute rotations ``R`` (N, 3, 3)
    so that Rw_j ~= Rw_i @ edge_R_e over the relative-rotation graph.

    Each iteration linearizes with left-multiplicative so(3) increments
    (Rw_k <- exp(r_k) Rw_k): the residual v_e = log(Rw_i Re Rw_j^T) moves to
    first order as v_e + r_i - r_j, so the normal matrix is a weighted graph
    Laplacian, solved as one (N-1, N-1) system with 3 right-hand sides.
    Cauchy weights (scale ``robust_sigma``, radians) guard outlier edges.
    Gauge: r_0 = 0."""
    n = R.shape[0]
    dev = R.device
    ei = torch.as_tensor(edge_i, device=dev).long()
    ej = torch.as_tensor(edge_j, device=dev).long()
    ew = torch.as_tensor(edge_weight, dtype=R.dtype, device=dev)
    edge_R = torch.as_tensor(edge_R, dtype=R.dtype, device=dev)
    eye = torch.eye(n - 1, dtype=R.dtype, device=dev)
    Rw = R
    for _ in range(iters):
        v = lie.so3_log(Rw[ei] @ edge_R @ Rw[ej].transpose(-1, -2))  # (E, 3)
        rn2 = (v * v).sum(-1)
        w = ew / (1.0 + rn2 / (robust_sigma * robust_sigma))
        w2 = w * w
        L = R.new_zeros((n, n))
        L.index_put_((ei, ei), w2, accumulate=True)
        L.index_put_((ej, ej), w2, accumulate=True)
        L.index_put_((ei, ej), -w2, accumulate=True)
        L.index_put_((ej, ei), -w2, accumulate=True)
        rhs = R.new_zeros((n, 3))
        rhs.index_add_(0, ej, w2[:, None] * v)
        rhs.index_add_(0, ei, -w2[:, None] * v)
        r = torch.linalg.solve_ex(L[1:, 1:] + 1e-9 * eye, rhs[1:])[0]
        r = torch.cat([R.new_zeros((1, 3)), r])
        r = torch.where(torch.isfinite(r), r, 0.0)
        Rw = lie.so3_exp(r) @ Rw
    return Rw


def solve_scale_drift(n: int, con_i, con_j, con_log, con_weight,
                      smooth_weight: float = 1.0) -> np.ndarray:
    """Per-segment monocular log scale drift by linear least squares, on the
    host in float64 (a few hundred rows by n ~ F columns).

    Variables x_k = log of segment k's chain-scale error, k in [0, n).
    Rows: smoothness x_{k+1} - x_k = 0 (weight ``smooth_weight``),
    measurements x_{con_i[m]} - x_{con_j[m]} = con_log[m] (weight
    ``con_weight[m]``), and the gauge x_0 = 0 as a strong prior row.  Returns
    x (n,), the log correction to divide out of each segment's
    translation."""
    con_i = np.asarray(con_i, np.int64)
    con_j = np.asarray(con_j, np.int64)
    m = con_i.shape[0]
    rows = (n - 1) + m + 1
    A = np.zeros((rows, n))
    b = np.zeros((rows,))
    k = np.arange(n - 1)
    A[k, k + 1] += smooth_weight
    A[k, k] += -smooth_weight
    r = n - 1 + np.arange(m)
    w = np.asarray(con_weight, np.float64)
    np.add.at(A, (r, con_i), w)
    np.add.at(A, (r, con_j), -w)
    b[r] = np.asarray(con_log, np.float64) * w
    A[rows - 1, 0] = 1e3  # gauge: x_0 = 0
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x
