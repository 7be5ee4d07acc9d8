"""Monocular SLAM of whole sequences through the port's SLAM entry points:
odometry, loop closure, the robust loop pose graph and global bundle
adjustment.

Set-up renders a pool of ``traffic["pool"]`` sequences of the
configuration's room (``data.render``), sequence i with its own noise field
and RANSAC draws from the run's seed (``pool_seed``; sequence 0 takes the
run's seed itself, as the odometry cell does), keeps their frames on the
host, and runs each once.  A request runs the next sequence of the pool, in
order, in ``tools/vo_bench --loops``' call order: ``slam.frontend_features``
and ``frontend_matches``, ``propose_loop_closures`` (the configuration's
``gap``, ``top_k`` and ``min_matches``), then ``run_vo_matches`` with the
loop pairs, ``ba_refine=True``, ``stage_times`` and ``_internals``.
Set-up refuses, before it renders, a configuration the program does not
run: a ``ba`` block other than ``refine_with_ba``'s defaults, or a
``solve_dtype`` other than the one the loop pose graph and global BA solve
in (``posegraph.SOLVE_DTYPE``, ``ba.GLOBAL_SOLVE_DTYPE``).

What the check needs is kept: the features, the loop pairs, the pose graph
as the program assembled it (``_internals["graph"]``) and its result, and
each bundle-adjustment round's problem and result.  The rounds are seen by
a wrapper around ``ba.optimize`` that the driver installs for its life: it
holds the problem the call was given and the poses and points it returned,
for the global (unbatched) solves.  At the request's end, after the
program's own spans, the kept tensors are fetched to the host in one pass
(about 3.7 MiB at the cell's size), so that kept answers hold no device memory.

The kept answers are compared with the plain references
(``reference.brief``, ``reference.slam``, ``reference.ba``, float64), answer
by answer, and aggregated per pool sequence (``_aggregate``): the exact
counts by their worst, the geometry numbers by the worst over the sequences
of each one's median over its repeats.  Which of them decide ``correct`` is
the check file's choice (``checks/<cell>.json``); every number is printed on
stderr.  The route is taken from the reference, not from the program: where
the reference keeps loop pairs, the program must close loops and run the
configuration's rounds, else the geometry numbers read infinite.
  * exactly (limit 0): the front-end's keypoints and descriptors
    (``frontend_mismatch``), the consecutive pairs' matches
    (``match_mismatch``), and the loop pairs kept with their matches
    (``loop_mismatch``: pairs on one side only, and slots matched
    differently in the pairs of both);
  * ``loop_pairs_per_edge``: the reference's kept loop pairs over the loop
    edges the program's chain accepted (``loop_ransac``, ``loop_refine``,
    the revisit and depth-ratio gates); infinite with no loop edge;
  * the loop pose graph against the reference's LM steps from the graph the
    program assembled: ``loop_graph_link_gap``, the widest gap of a
    consecutive pair's relative rotation (radians); ``loop_graph_gap``, the
    widest pose's rotation or position gap over the reference's path
    length; ``loop_graph_cost_ratio``, the program's Geman-McClure cost in
    float64 over the reference's;
  * rotation averaging and gating, the reference's own from the loop
    graph's poses: ``rotation_avg_gap_rad``, the widest rotation gap to the
    program's first problem, and ``ba_gate_mismatch_pct``, the observations
    its triangulation and gating keep otherwise than the program's first
    problem, in percent;
  * ``ba_cost_ratio``: over the rounds, the widest ratio of the Huber cost
    of the program's result, evaluated in float64, to the reference's after
    the same LM steps of the same conjugate-gradient budget from the same
    problem (infinite where a round is missing); ``ba_round<i>_exact_ratio``
    the same against exact steps (a direct solve);
  * ``ba_pose_gap``: the widest camera-centre gap of the final trajectory,
    aligned by a similarity, to the reference's own chain (rotation
    averaging, then each round triangulated, gated and solved from its
    previous result), over the reference's path length.
Also printed: the ATE of the loop stage and of the final trajectory, the
loop and edge counts, and what keeping an answer holds and costs (see
PERF.md).
"""

from __future__ import annotations

import contextlib
import inspect
import sys
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from benchmark.data import render
from benchmark.drivers.vo_sequence import _patched
from benchmark.reference import ba as ref_ba
from benchmark.reference import brief as ref_brief
from benchmark.reference import geometry as ref_geo
from benchmark.reference import se3
from benchmark.reference import slam as ref_slam

#: The configuration's ``ba`` block against ``refine_with_ba``'s keywords,
#: which ``run_vo_matches`` does not pass on: the program runs its defaults.
BA_DEFAULTS = {"rounds": "loop_ba_rounds", "iters": "loop_ba_iters", "cg_iters": "loop_cg_iters",
               "robust_delta": "robust_delta"}


def pool_seed(seed: int, index: int) -> int:
    """The noise and RANSAC seed of pool sequence ``index``."""
    return (int(seed) + 7919 * index) % (1 << 31)


class Slam:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device: torch.device,
                 limits: Dict[str, float]):
        t_import = time.perf_counter()
        from feature_detector_fast_tpu_torch.models import ba, posegraph, slam, twoview

        self.slam, self.ba, self.posegraph = slam, ba, posegraph
        self.device = device
        self.limits = limits
        self.loops, self.ba_cfg = config["loops"], config["ba"]
        defaults = inspect.signature(slam.refine_with_ba).parameters
        for key, name in BA_DEFAULTS.items():
            if defaults[name].default != self.ba_cfg[key]:
                raise ValueError(f"ba.{key} {self.ba_cfg[key]} is not the program's "
                                 f"{name}={defaults[name].default}")
        # The configuration's precision: a program that solves the loop pose
        # graph or global BA in another dtype (one that names none solves in
        # the poses' float32) cannot run this configuration.
        want = getattr(torch, config["solve_dtype"])
        for name, have in (("posegraph.SOLVE_DTYPE", getattr(posegraph, "SOLVE_DTYPE", None)),
                           ("ba.GLOBAL_SOLVE_DTYPE", getattr(ba, "GLOBAL_SOLVE_DTYPE", None))):
            if have != want:
                raise ValueError(f"solve_dtype {want} is not the program's {name} ({have})")
        scene = config["scene"]
        n = int(config["frames"])
        focal = (scene["fx"], scene["fy"])
        centre = (scene["width"] / 2.0 - 0.5, scene["height"] / 2.0 - 0.5)
        vo = config["vo"]
        t0 = time.perf_counter()
        self.pool = []
        for i in range(int(traffic["pool"])):
            s = pool_seed(seed, i)
            gt, frames = render.render_circuit(scene, n, s, device)
            cfg = slam.VOConfig(
                threshold=int(vo["threshold"]), count=int(vo["count"]),
                max_keypoints=int(vo["max_keypoints"]),
                camera=twoview.Camera(*focal, *centre),
                ransac_hypotheses=int(vo["ransac_hypotheses"]),
                pair_refine_iters=int(vo["pair_refine_iters"]),
                pair_refine_cg=int(vo["pair_refine_cg"]),
                loop_pose_graph_iters=int(self.loops["pose_graph_iters"]),
                loop_robust_delta=float(self.loops["robust_delta"]), seed=s)
            self.pool.append({"gt": gt, "frames": list(frames.cpu().numpy()), "cfg": cfg})
            del frames
        self.frames_per_request = n
        self.next = 0
        self.current = 0
        self.rounds = None
        #: Each pool sequence's references, made at its first check.
        self.refs = {}
        #: The solver the kept wrapper calls (a control may wrap it).
        self.inner = self.saved_optimize = ba.optimize
        ba.optimize = self._keep
        self.spans: Dict[str, float] = {}
        t1 = time.perf_counter()
        for _ in self.pool:  # every sequence's shapes once
            self.request()
        self.spans.clear()
        self.next = 0
        print(f"set-up: import {t0 - t_import:.3f} s, render {t1 - t0:.3f} s, warm-up "
              f"{len(self.pool)} sequences {time.perf_counter() - t1:.3f} s", file=sys.stderr)

    def _keep(self, p, *a, **k):
        """``ba.optimize`` while the driver lives: the call, and for a global
        solve inside a request, its problem and result kept."""
        out = self.inner(p, *a, **k)
        if self.rounds is not None and p.poses.dim() == 3:
            self.rounds.append((p, out[0], out[1]))
        return out

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def request(self):
        slam, dev = self.slam, self.device
        self.current = k = self.next % len(self.pool)
        self.next += 1
        seq = self.pool[k]
        frames, cfg = seq["frames"], seq["cfg"]
        rounds = self.rounds = []
        try:
            with self._span("frontend"):
                feats = slam.frontend_features(frames, cfg, device=dev)
                pairs = slam.frontend_matches(frames, cfg, features=feats, device=dev)
            with self._span("loop_propose"):
                loops = slam.propose_loop_closures(
                    frames, cfg, gap=int(self.loops["gap"]),
                    min_matches=int(self.loops["min_matches"]), top_k=int(self.loops["top_k"]),
                    features=feats, device=dev)
            stages, internals = {}, {}
            with self._span("vo_matches"):
                poses = slam.run_vo_matches(pairs, cfg, loop_pairs=loops, ba_refine=True,
                                            _internals=internals, stage_times=stages, device=dev)
        finally:
            self.rounds = None
        for name, v in stages.items():
            self.spans[f"stage.{name}"] = self.spans.get(f"stage.{name}", 0.0) + v
        # After the program's own spans: what the check needs, fetched to the
        # host, so that kept answers hold no device memory.
        t0 = time.perf_counter()
        kept = _host((feats, tuple(internals["graph"]), [(tuple(p), w2c, pts)
                                                         for p, w2c, pts in rounds]))
        return {"seq": k, "poses": poses, "feats": kept[0], "graph": kept[1], "rounds": kept[2],
                "pairs": [(p[2], p[3]) for p in pairs],
                "loops": [(lp[0], lp[1], lp[4], lp[5]) for lp in loops],
                "graph_poses": internals["graph_poses"], "rot_edges": internals["rot_edges"],
                "keep_s": time.perf_counter() - t0}

    def release(self) -> None:
        self.ba.optimize = self.saved_optimize
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check

    def _reference(self, k: int):
        """Sequence ``k``'s plain front-end, consecutive matches and loop
        proposals, on the run's device."""
        vo = self.pool[k]["cfg"]
        frames = torch.as_tensor(np.stack(self.pool[k]["frames"]), device=self.device)
        xy, _, desc, dvalid = ref_brief.features(frames, vo.threshold, vo.count,
                                                 vo.max_keypoints)
        odo = [ref_brief.match(desc[i], dvalid[i], desc[i + 1], dvalid[i + 1])
               for i in range(len(frames) - 1)]
        loops = ref_slam.propose(desc, dvalid, int(self.loops["gap"]), int(self.loops["top_k"]),
                                 int(self.loops["min_matches"]))
        return xy, desc, dvalid, odo, loops

    def check(self, kept) -> Tuple[List[Tuple[str, float, float]], int]:
        per: Dict[int, Dict[str, List[float]]] = {}
        failed = 0
        for _, a in kept:
            if a["seq"] not in self.refs:
                self.refs[a["seq"]] = self._reference(a["seq"])
            xy, desc, dvalid, odo, loops = self.refs[a["seq"]]
            pxy, pdesc, pvalid = (t.to(self.device) for t in a["feats"])
            front = int((pxy != xy).any(-1).sum()) + int((pvalid != dvalid).sum())
            front += int(((pdesc != desc).any(-1) & pvalid & dvalid).sum())
            match = sum(_slot_mismatch(pok, pidx, r) for (pok, pidx), r in zip(a["pairs"], odo))
            numbers = {"frontend_mismatch": front, "match_mismatch": match,
                       "loop_mismatch": _loop_mismatch(a["loops"], loops)}
            numbers.update(self.geometry(a, len(loops)))
            numbers["kept_mib"] = _kept_bytes(a) / 2**20
            numbers["keep_ms"] = 1e3 * a["keep_s"]
            print(f"slam sequence {a['seq']}: " + " ".join(f"{k} {v:.6g}" for k, v in
                                                          numbers.items()), file=sys.stderr)
            seq = per.setdefault(a["seq"], {})
            for k, v in numbers.items():
                seq.setdefault(k, []).append(float(v))
            failed += int(front + match + numbers["loop_mismatch"] > 0
                          or not all(np.isfinite(v) for v in numbers.values()))
        print(f"checked {len(kept)} answers of {len(per)} sequences against the plain front-end, "
              f"loop proposal, pose graph and bundle adjustment", file=sys.stderr)
        return [(k, _aggregate(k, [seq[k] for seq in per.values()]), lim)
                for k, lim in self.limits.items()], failed

    def geometry(self, a, ref_loops: int) -> Dict[str, float]:
        """One answer's loop graph and bundle-adjustment numbers, compared
        and reported.  The route is the configuration's and the reference's,
        not the program's: where the reference keeps loop pairs, the graph
        must hold loop edges (``loop_pairs_per_edge``, the reference's kept
        pairs over the program's loop edges, infinite with none) and is
        compared at the loop settings, and the rounds of global bundle
        adjustment must be the configuration's (each number infinite
        otherwise).  Where the reference keeps none (a test's tiny
        sequence), the odometry graph's steps and, below
        ``windowed_threshold`` frames, one plain global BA; the windowed
        route of longer loop-free sequences is not compared (BA numbers 1
        and 0)."""
        out = {}
        g = a["graph"]
        vo = self.pool[a["seq"]]["cfg"]
        n = int(g[0].shape[0])
        out["loop_edges"] = int(g[1].shape[0]) - (n - 1)
        closed = ref_loops > 0
        out["loop_pairs_per_edge"] = (ref_loops / out["loop_edges"] if out["loop_edges"] > 0
                                      else float("inf") if closed else 0.0)
        gt = self.pool[a["seq"]]["gt"]
        out["ate_loop_stage_pct"] = ref_geo.ate_pct(a["graph_poses"], gt)
        out["ate_pct"] = ref_geo.ate_pct(a["poses"], gt)
        out["loop_pairs"] = len(a["loops"])
        names = ("loop_graph_gap", "loop_graph_link_gap", "loop_graph_cost_ratio",
                 "rotation_avg_gap_rad", "ba_gate_mismatch_pct", "ba_cost_ratio", "ba_pose_gap")
        if closed and out["loop_edges"] <= 0:
            return {**out, **{k: float("inf") for k in names}}
        pg_delta = float(self.loops["robust_delta"]) if closed else 0.0
        ref_poses, ref_costs = ref_slam.pose_graph(
            *g, int(self.loops["pose_graph_iters"]) if closed else vo.pose_graph_iters, pg_delta)
        prog = torch.as_tensor(a["graph_poses"])
        out["loop_graph_gap"] = _trajectory_gap(prog, ref_poses, rotations=True)
        out["loop_graph_link_gap"] = _link_gap(prog, ref_poses)
        out["loop_graph_cost_ratio"] = (ref_slam.graph_cost(prog, *g[1:], pg_delta) / ref_costs[-1]
                                        if closed else 1.0)
        defaults = {k: v.default for k, v in
                    inspect.signature(self.slam.refine_with_ba).parameters.items()}
        damping, n_fixed = float(self.ba_cfg["damping"]), int(self.ba_cfg["n_fixed_cams"])
        if closed:
            n_rounds, iters, cg = (int(self.ba_cfg[k]) for k in ("rounds", "iters", "cg_iters"))
            delta = float(self.ba_cfg["robust_delta"])
        elif n < defaults["windowed_threshold"]:
            n_rounds, iters, cg, delta = 1, defaults["iterations"], defaults["cg_iters"], 0.0
        else:
            out.update(rotation_avg_gap_rad=0.0, ba_gate_mismatch_pct=0.0, ba_cost_ratio=1.0,
                       ba_pose_gap=0.0)
            return out
        rounds = a["rounds"]
        if len(rounds) != n_rounds:
            return {**out, **{k: float("inf") for k in names[3:]}}
        problems = [ref_ba.Problem(*(t.to(self.device) for t in p[:6])) for p, _, _ in rounds]
        ratios = []
        for i, (p, (_, w2c, pts)) in enumerate(zip(problems, rounds)):
            cost = float(ref_ba.huber_cost(p._replace(w2c=w2c.to(self.device),
                                                      points=pts.to(self.device)).f64(), delta))
            _, costs = ref_ba.solve(p, iters, damping, delta, n_fixed, cg)
            ratios.append(cost / costs[-1] if costs[-1] > 0 else float("inf"))
            out[f"ba_round{i}_ratio"] = ratios[-1]
            _, exact = ref_ba.solve(p, iters, damping, delta, n_fixed)
            out[f"ba_round{i}_exact_ratio"] = cost / exact[-1] if exact[-1] > 0 else float("inf")
        out["ba_cost_ratio"] = max(ratios)
        # The reference's own chain from the loop graph's poses: its rotation
        # averaging (loop route), then each round triangulated, gated and
        # solved from its previous result, on the program's tracks.
        cur = torch.as_tensor(a["graph_poses"], dtype=torch.float64, device=self.device)
        out["rotation_avg_gap_rad"] = 0.0
        if closed and a["rot_edges"] is not None:
            ei, ej, eR, ew = a["rot_edges"]
            Rw = ref_slam.rotation_average(cur[:, :3, :3], ei, ej, np.asarray(eR), ew)
            prog_R = torch.linalg.inv(problems[0].w2c.to(torch.float64))[:, :3, :3]
            out["rotation_avg_gap_rad"] = float(se3.angle(prog_R.transpose(1, 2) @ Rw).max())
            cur[:, :3, :3] = Rw
        for i, p in enumerate(problems):
            w2c = torch.linalg.inv(cur)
            pts, valid = _gated(w2c, p)
            out[f"ba_round{i}_gate_mismatch"] = int((valid != p.valid.to(self.device)).sum())
            if i == 0:
                out["ba_gate_mismatch_pct"] = 100.0 * out["ba_round0_gate_mismatch"] / len(valid)
            chain, _ = ref_ba.solve(p._replace(w2c=w2c, points=pts, valid=valid), iters, damping,
                                    delta, n_fixed, cg)
            cur = torch.linalg.inv(chain.w2c)
        out["ba_pose_gap"] = _trajectory_gap(torch.as_tensor(a["poses"]), cur.cpu())
        return out

    def controls(self) -> Dict[str, Callable]:
        """The control and the planted faults by name, each a context
        manager under which requests give their answers: ``nonstrict``, the
        front-end's exact semantics broken (the plain FAST with >= t in
        place of the program's detector and descriptors); ``ba_skipped``,
        ``refine_with_ba`` returning its input poses; ``ba_half_iters``, half
        the LM steps of each round; ``ba_tf32``, the solves with TF32
        allowed, a precision below the configuration's; ``ba_bf16``, the
        global solves computed in bfloat16, the nearest precision below the
        configuration's float32; ``loop_turned``, one loop edge's measured
        rotation (the edge the chain fits best) turned by a degree before the
        pose graph; ``pose_turned``, the pose graph's answer altered where it
        is produced (its middle pose turned by a degree); ``loops_dropped``, the
        proposed loop pairs not handed to ``run_vo_matches``, so that no loop
        is closed and the odometry route runs; ``rotation_avg_skipped``,
        bundle adjustment started from the loop graph's rotations without
        rotation averaging."""
        return {"nonstrict": self._nonstrict, "ba_skipped": self._ba_skipped,
                "ba_half_iters": self._ba_half_iters, "ba_tf32": self._ba_tf32,
                "ba_bf16": self._ba_bf16, "loop_turned": self._loop_turned,
                "pose_turned": self._pose_turned, "loops_dropped": self._loops_dropped,
                "rotation_avg_skipped": self._rotation_avg_skipped}

    def _nonstrict(self):
        feats = []
        for seq in self.pool:
            vo = seq["cfg"]
            frames = torch.as_tensor(np.stack(seq["frames"]), device=self.device)
            xy, _, desc, dvalid = ref_brief.features(frames, vo.threshold, vo.count,
                                                     vo.max_keypoints, strict=False)
            feats.append((xy, desc, dvalid))
        return _patched(self.slam, "frontend_features",
                        lambda real: lambda *a, **k: feats[self.current])

    def _loops_dropped(self):
        return _patched(self.slam, "run_vo_matches",
                        lambda real: lambda *a, **k: real(*a, **{**k, "loop_pairs": []}))

    def _rotation_avg_skipped(self):
        return _patched(self.slam, "refine_with_ba",
                        lambda real: lambda *a, **k: real(*a, **{**k, "graph_edges": None}))

    def _ba_skipped(self):
        return _patched(self.slam, "refine_with_ba", lambda real: lambda poses, *a, **k: poses)

    def _ba_half_iters(self):
        half = int(self.ba_cfg["iters"]) // 2
        return _patched(self.slam, "refine_with_ba",
                        lambda real: lambda *a, **k: real(*a, **{**k, "loop_ba_iters": half}))

    def _ba_tf32(self):
        from feature_detector_fast_tpu_torch.utils import precision

        def tf32_on():
            matmul = torch.backends.cuda.matmul
            old = matmul.allow_tf32
            matmul.allow_tf32 = True
            return lambda: setattr(matmul, "allow_tf32", old)

        def wrap(real):
            def optimize(*a, **k):
                with _patched(precision, "_full_precision", lambda _: tf32_on):
                    return real(*a, **k)
            return optimize
        return _patched(self.ba, "optimize", wrap)

    def _ba_bf16(self):
        def wrap(real):
            def optimize(p, *a, **k):
                if p.poses.dim() != 3:
                    return real(p, *a, **k)
                low = p._replace(poses=p.poses.bfloat16(), points=p.points.bfloat16(),
                                 obs_uv=p.obs_uv.bfloat16())
                return tuple(t.to(p.poses.dtype) for t in real(low, *a, **k))
            return optimize
        return _patched(self, "inner", wrap)

    def _loop_turned(self):
        turn = torch.as_tensor(_turn_x(1.0))

        def wrap(real):
            def optimize(g, *a, **k):
                n = g.poses.shape[0]
                if g.edge_T.shape[0] > n - 1:
                    # the loop edge that the chain fits best, whose weight
                    # the robust kernel keeps highest
                    r = self.posegraph.edge_residuals(g.poses, g)[n - 1:]
                    e = n - 1 + int(torch.linalg.vector_norm(r, dim=1).argmin())
                    T = g.edge_T.clone()
                    T[e, :3, :3] = turn.to(T) @ T[e, :3, :3]
                    g = g._replace(edge_T=T)
                return real(g, *a, **k)
            return optimize
        return _patched(self.posegraph, "optimize", wrap)

    def _pose_turned(self):
        turn = torch.as_tensor(_turn_x(1.0))

        def wrap(real):
            def optimize(*a, **k):
                poses, costs = real(*a, **k)
                poses = poses.clone()
                mid = len(poses) // 2
                poses[mid, :3, :3] = turn.to(poses) @ poses[mid, :3, :3]
                return poses, costs
            return optimize
        return _patched(self.posegraph, "optimize", wrap)


def _turn_x(degrees: float) -> np.ndarray:
    c, s = np.cos(np.radians(degrees)), np.sin(np.radians(degrees))
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def _aggregate(name: str, by_seq: List[List[float]]) -> float:
    """A number over the kept answers, given per pool sequence: the exact
    counts their worst; a geometry number the worst over the sequences of
    each one's median over its repeats (infinite where any answer's is).  A
    fault on one sequence of the pool shows; a repeat's excursion (the
    card's float32 solves are not repeatable) does not decide alone."""
    if name.endswith("_mismatch"):
        return max(max(v) for v in by_seq)
    return max(float("inf") if not np.isfinite(v).all() else float(np.median(v)) for v in by_seq)


def _host(x):
    """``x``'s tensors, in nested tuples and lists, on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    return x


def _kept_bytes(answer) -> int:
    """Bytes of the tensors a kept answer holds."""
    rounds = [t for p, w2c, pts in answer["rounds"] for t in (*p, w2c, pts)]
    return sum(t.numel() * t.element_size() for t in (*answer["feats"], *answer["graph"], *rounds)
               if isinstance(t, torch.Tensor))


def _slot_mismatch(ok, idx, ref: torch.Tensor) -> int:
    """Slots of one pair matched otherwise than the reference's ``ref``."""
    ref = ref.cpu().numpy()
    ok = np.asarray(ok, bool)
    return int((ok != (ref >= 0)).sum()) + int((np.asarray(idx)[ok] != ref[ok]).sum())


def _loop_mismatch(program, reference) -> int:
    """Loop pairs that one side keeps and the other does not, and the slots
    of the pairs both keep that are matched otherwise."""
    ref = {(i, j): idx for i, j, idx in reference}
    prog = {(int(i), int(j)): (ok, idx) for i, j, ok, idx in program}
    bad = len(set(ref) ^ set(prog))
    return bad + sum(_slot_mismatch(*prog[key], ref[key]) for key in set(ref) & set(prog))


def _trajectory_gap(est: torch.Tensor, ref: torch.Tensor, rotations: bool = False) -> float:
    """The widest camera-centre gap of world_T_cam ``est`` to ``ref`` over
    ``ref``'s path length, and with ``rotations`` the widest rotation gap in
    radians if larger; inf where ``est`` is not finite.  Without
    ``rotations`` the centres are first aligned by the least-squares
    similarity (Umeyama 1991): bundle adjustment with one camera fixed
    leaves the scale free, and two correct solvers may end at different
    scales."""
    est, ref = est.to(torch.float64).cpu(), ref.to(torch.float64).cpu()
    if not torch.isfinite(est).all():
        return float("inf")
    e, g = est[:, :3, 3], ref[:, :3, 3]
    if not rotations:
        mu_e, mu_g = e.mean(0), g.mean(0)
        u, d, vt = torch.linalg.svd((g - mu_g).T @ (e - mu_e) / len(e))
        fix = torch.ones(3, dtype=torch.float64)
        fix[2] = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
        scale = (d * fix).sum() / ((e - mu_e) ** 2).sum(1).mean().clamp(min=1e-300)
        e = scale * (e - mu_e) @ (u @ torch.diag(fix) @ vt).T + mu_g
    path = float(torch.linalg.vector_norm(g[1:] - g[:-1], dim=1).sum())
    gap = float(torch.linalg.vector_norm(e - g, dim=1).max()) / path
    if rotations:
        gap = max(gap, float(se3.angle(est[:, :3, :3].transpose(1, 2) @ ref[:, :3, :3]).max()))
    return gap


def _link_gap(est: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest angle (radians) between a consecutive pair's relative
    rotation in world_T_cam ``est`` and in ``ref``: a pose turned against its
    neighbours shows here, a smooth bend of the whole graph hardly."""
    est, ref = est.to(torch.float64).cpu(), ref.to(torch.float64).cpu()
    if not torch.isfinite(est).all():
        return float("inf")
    link = est[:-1, :3, :3].transpose(1, 2) @ est[1:, :3, :3]
    ref_link = ref[:-1, :3, :3].transpose(1, 2) @ ref[1:, :3, :3]
    return float(se3.angle(link.transpose(1, 2) @ ref_link).max())


def _gated(w2c: torch.Tensor, p: ref_ba.Problem):
    """(points, validity) of ``p``'s tracks triangulated and gated afresh
    from world -> camera poses ``w2c``."""
    w2c = w2c.to(torch.float64)
    n_lm = int(p.points.shape[0])
    pts = ref_slam.triangulate(w2c, p.obs_cam.to(w2c.device), p.obs_lm.to(w2c.device),
                               p.obs_uv.to(w2c.device), n_lm)
    return pts, ref_slam.gate(w2c, pts, p.obs_cam.to(w2c.device), p.obs_lm.to(w2c.device),
                              p.obs_uv.to(w2c.device))


def make(config, traffic, seed, device, limits):
    return Slam(config, traffic, seed, device, limits)
