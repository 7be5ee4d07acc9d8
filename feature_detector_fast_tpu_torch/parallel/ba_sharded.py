"""Distributed bundle adjustment: observations split over a device mesh,
the Schur-complement reductions summed across the shards.

Counterpart of ``feature_detector_fast_tpu.parallel.ba_sharded``.  There,
``shard_map`` runs every shard's ``ba.ba_step`` in lockstep and ``psum``
sums their partial segment reductions, so every shard holds the same
reduced camera system and runs the same CG.  Here the mesh's cells are
grouped into runs of consecutive cells on one device; the cells of a run
are the leading axis of one batched ``BAProblem`` (observations (S, O/S),
poses broadcast to (S, C, 4, 4), each cell's landmark shard (S, L', 3)),
and ``ba_step``'s ``psum`` hook sums that axis and broadcasts the sum back
to every cell.  Where the mesh holds more than one run (distinct cards, or
a card and the CPU), one host thread a run calls ``ba_step``, and each psum
also sums the runs' partials on the mesh's first device, behind a barrier,
and copies the sum back.  A mesh of one device repeated (one card, or the
CPU in the tests) is a single run: no thread and no copy.

``psum`` changes the order of the float sums against the single-device
step, so the two agree to a tolerance, not bit for bit (as in the JAX
package).
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import torch

from ..models import ba as ba_lib
from ..utils.precision import tf32_off
from . import mesh as meshlib


def pad_observations(p: ba_lib.BAProblem, multiple: int) -> ba_lib.BAProblem:
    """Pad the observation arrays to a multiple of ``multiple`` with invalid
    slots (camera 0, landmark 0), so every shard holds as many."""
    pad = (-p.obs_cam.shape[0]) % multiple
    if pad == 0:
        return p

    def z(a, fill):
        return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])

    return p._replace(obs_cam=z(p.obs_cam, 0), obs_lm=z(p.obs_lm, 0), obs_uv=z(p.obs_uv, 0.0),
                      obs_valid=z(p.obs_valid, False))


class _AllReduce:
    """Sum one partial per run on ``root`` and hand every run the sum.  The
    runs' threads call it in the same order; two barriers a call keep one
    call's sum from overwriting the last before every run has read it."""

    def __init__(self, n_runs: int, root: torch.device):
        self.n_runs = n_runs
        self.root = root
        self.barrier = threading.Barrier(n_runs)
        self.parts: List[Optional[torch.Tensor]] = [None] * n_runs
        self.total: Optional[torch.Tensor] = None

    def __call__(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        if self.n_runs == 1:
            return x
        self.parts[rank] = x.to(self.root)
        self.barrier.wait()
        if rank == 0:
            self.total = torch.stack(self.parts).sum(0)
        self.barrier.wait()
        return self.total.to(x.device)


def _cells_step(p: ba_lib.BAProblem, grid: Sequence[Sequence[torch.device]], damping: float,
                cg_iters: int, robust_delta: float):
    """One Gauss-Newton / Schur step with observations split over the rows of
    ``grid`` (the data axis) and landmarks over its columns (the model
    axis).  Returns (new poses, new points (L, 3), cost) on grid[0][0]."""
    n_data, n_model = len(grid), len(grid[0])
    p = pad_observations(p, n_data)
    n_lm = p.points.shape[0]
    pad_l = (-n_lm) % n_model
    points = torch.cat([p.points, p.points.new_zeros((pad_l, 3))]) if pad_l else p.points
    l_shard = (n_lm + pad_l) // n_model
    o_shard = p.obs_cam.shape[0] // n_data
    cells = [(d, k) for d in range(n_data) for k in range(n_model)]
    runs = meshlib.device_runs([grid[d][k] for d, k in cells])
    root = grid[0][0]
    reduce = _AllReduce(len(runs), root)
    outs: List[Optional[Tuple[torch.Tensor, ...]]] = [None] * len(runs)
    errors: List[Exception] = []

    def run_step(rank: int, dev: torch.device, first: int, m: int) -> None:
        try:
            idx_d = torch.tensor([cells[c][0] for c in range(first, first + m)], device=dev)
            idx_k = torch.tensor([cells[c][1] for c in range(first, first + m)], device=dev)

            def shard(a):
                return a.to(dev).reshape((n_data, o_shard) + tuple(a.shape[1:]))[idx_d]

            # Landmark shard k holds [k l_shard, (k + 1) l_shard); a cell
            # keeps the observations of its own landmarks.
            ol = shard(p.obs_lm) - idx_k[:, None] * l_shard
            mine = (ol >= 0) & (ol < l_shard) & shard(p.obs_valid)
            local = ba_lib.BAProblem(
                poses=p.poses.to(dev).expand((m,) + tuple(p.poses.shape)),
                points=points.to(dev).reshape(n_model, l_shard, 3)[idx_k],
                obs_cam=shard(p.obs_cam), obs_lm=ol.clamp(0, l_shard - 1),
                obs_uv=shard(p.obs_uv), obs_valid=mine, n_fixed_cams=p.n_fixed_cams)

            def psum(x):  # over every cell
                return reduce(rank, x.sum(0)).expand_as(x)

            def psum_data(x):  # over the cells of each landmark shard
                part = x.new_zeros((n_model,) + tuple(x.shape[1:])).index_add_(0, idx_k, x)
                return reduce(rank, part)[idx_k]

            new_poses, new_points, cost = ba_lib.ba_step.__wrapped__(
                local, damping, cg_iters, psum=psum, psum_lm=psum_data,
                robust_delta=robust_delta)
            outs[rank] = (new_poses, new_points, cost, idx_d, idx_k)
        except Exception as e:  # re-raised below, after every run's thread has ended
            errors.append(e)
            reduce.barrier.abort()

    with tf32_off():  # the flag is global: set once around every run's thread
        if len(runs) == 1:
            run_step(0, *runs[0])
        else:
            threads = [threading.Thread(target=run_step, args=(r,) + run)
                       for r, run in enumerate(runs)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    shards = {}  # landmark shard k -> its points from a cell of data row 0
    for new_poses, new_points, cost, idx_d, idx_k in outs:
        for c in range(idx_d.shape[0]):
            if int(idx_d[c]) == 0:
                shards[int(idx_k[c])] = new_points[c].to(root)
    new_points = torch.cat([shards[k] for k in range(n_model)])[:n_lm]
    new_poses, _, cost = outs[0][:3]
    return new_poses[0].to(root), new_points, cost[0].to(root)


def ba_step_sharded(p: ba_lib.BAProblem, mesh: meshlib.Mesh, damping: float = 1e-6,
                    cg_iters: int = 30, robust_delta: float = 0.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One distributed Gauss-Newton / Schur step: observations split over
    the mesh's data devices, poses and points replicated.  Returns
    (new_poses, new_points, cost) on the mesh's first device.
    ``robust_delta`` > 0 makes it a Huber-IRLS step (the weights are per
    observation, so the split does not change them)."""
    grid = [[d] for d in mesh.devices_along(meshlib.DATA_AXIS)]
    return _cells_step(p, grid, damping, cg_iters, robust_delta)


def ba_step_sharded2d(p: ba_lib.BAProblem, mesh: meshlib.Mesh, damping: float = 1e-6,
                      cg_iters: int = 30, robust_delta: float = 0.0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Gauss-Newton / Schur step on a 2-D (data x model) mesh:
    observations split over ``data``, landmark state (points, Hll blocks,
    back-substitution) over ``model``.  The reduced camera system sums over
    every cell; landmark-side reductions sum over ``data`` only (each
    landmark lives on one model shard).  Returns (new_poses, new_points
    (L, 3), cost) on the mesh's first device."""
    grid = [list(row) for row in mesh.devices]
    return _cells_step(p, grid, damping, cg_iters, robust_delta)


def optimize_sharded(p: ba_lib.BAProblem, iterations: int = 8, cg_iters: int = 30,
                     damping: float = 1e-6, robust_delta: float = 0.0, *,
                     mesh: meshlib.Mesh) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed LM-damped BA (``ba.optimize`` with ``ba_step_sharded``'s
    steps): a step that raises the cost is rejected (``torch.where``, no
    host check).  ``robust_delta`` > 0: Huber-IRLS steps accepted on the
    true Huber objective.  Returns (poses, points, per-iteration cost) on
    the mesh's first device."""
    root = mesh.devices_along(meshlib.DATA_AXIS)[0]
    p = p._replace(**{f: getattr(p, f).to(root) for f in p._fields if f != "n_fixed_cams"})
    poses, points = p.poses, p.points
    costs = []
    with tf32_off():
        for _ in range(iterations):
            pp = p._replace(poses=poses, points=points)
            new_poses, new_points, cost = ba_step_sharded(pp, mesh, damping, cg_iters, robust_delta)
            if robust_delta > 0.0:
                cost = ba_lib.total_cost(pp, robust_delta)
            c_new = ba_lib.total_cost(p._replace(poses=new_poses, points=new_points),
                                      robust_delta)
            better = c_new < cost
            poses = torch.where(better, new_poses, poses)
            points = torch.where(better, new_points, points)
            costs.append(torch.minimum(c_new, cost))
    return poses, points, torch.stack(costs)
