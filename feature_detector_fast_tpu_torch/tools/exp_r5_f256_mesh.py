"""Scale evaluation of the SLAM back-end: the 128-frame staged circuit and the
256-frame quad-lap circuit with bundle adjustment on a mesh.

Counterpart of the JAX package's ``tools/exp_r5_f256_mesh.py`` and of its
``tests/test_render_vo.py::test_staged_128_frames_vga``, on ``vo_bench``'s
rendered 640 x 480 circuit (seed 3, every degradation) at K=512.  Two
protocols, each in the configuration the JAX package sets:

* ``staged128`` (tests/test_render_vo.py:218-242, run there at 128 frames
  and 2 laps): ``loop_ratio_mad_max=0.15``, ``loop_edge_weight=0.3``,
  ``loop_edge_min_gap`` 3/8 of the circuit (48 at 128 frames),
  ``propose_loop_closures(gap=10)`` with the automatic ``top_k`` (8 beyond
  64 frames) and ``min_matches`` 60; gates a1 < 0.6 a0 and a2 < a1.
* ``f256`` (tools/exp_r5_f256_mesh.py:56-116, run there at 256 frames and
  4 laps): ``vo_bench.vo_config`` (``loop_edge_min_gap=(3n)//4``),
  ``propose_loop_closures(gap=10, top_k=8, min_matches=120)``; gates
  revisit recall >= 0.8, a1 < 0.7 a0 and a2 <= 1.05 a1, a2 being BA on the
  mesh where there is one.

Stages: odometry, + loops, + BA on one device.  A mesh (``mesh_devices``)
adds, under either protocol, BA on the mesh (``parallel.ba_sharded``
through ``refine_with_ba(mesh=...)``) and the gate |a2(mesh) - a2(one)| <
0.3 max.  Both BA stages refine the loop stage's pose graph
(``run_vo_matches``' ``_internals``), which is what
``run_vo_matches(ba_refine=True)`` does after the same loop stage; the
loop stage does not use the mesh (only BA distributes).  The signature
pre-gate's recall of the geometric revisits (:func:`revisit_recall`) is
recorded under both protocols.  The JAX package's absolute 1.5% bound on
the final ATE is reported beside each final ATE (``under_jax_bound``), not
gated: a fixed-seed ATE rests on RANSAC draws the port cannot reproduce.

Each stage records its ATE (% of the trajectory's length), its seconds by
the host clock and two device-memory readings: the stage's own peak
(``stage_peak_bytes``: the peak over the stage less what was allocated when
it began) and the process's peak over the stage (``process_peak_bytes``).
The dispatch counts (``_common.dispatch_counts``) of one ``refine_with_ba``
and one loop-graph ``posegraph.optimize`` at the run's size follow.

    python -m feature_detector_fast_tpu_torch.tools.exp_r5_f256_mesh [frames]
        [--protocol staged128|f256] [--mesh N] [--device cpu]

The circuit has ``frames // 64`` laps.  ``--protocol`` defaults to
``f256``; ``--mesh N`` (default 8) repeats the device N times, as the card
runs the mesh routes, and ``--mesh 0`` runs no mesh.  One JSON object per
line on stdout; the exit code is 1 if a gate failed.
"""

from __future__ import annotations

import sys
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io import render
from ..models import posegraph, slam
from ..parallel import mesh as meshlib
from ..utils import precision
from . import _common, vo_bench

#: The JAX package's bound on the final ATE, % of the trajectory
#: (tools/exp_r5_f256_mesh.py:117, tests/test_render_vo.py:242).
JAX_BOUND_PCT = 1.5
#: The two protocols: the F=128 staged test's and the F=256 tool's.
PROTOCOLS = ("staged128", "f256")
#: Mesh against one device: |a2(mesh) - a2(one)| below this share of the
#: larger (tools/exp_r5_f256_mesh.py:115).
MESH_TOL = 0.3


def revisit_recall(loops: Sequence[Tuple], frames: int, laps: int) -> float:
    """Share of the frames i = 0, 4, 8, ... < frames - frames / laps whose
    geometric revisit i + frames / laps (the same circuit position a lap
    later), within 4 frames, is among their proposed loop partners j."""
    period = frames // laps
    by_i = {}
    for i, j, *_ in loops:
        by_i.setdefault(int(i), []).append(int(j))
    starts = range(0, frames - period, 4)
    hits = sum(any(abs(j - i - period) <= 4 for j in by_i.get(i, ())) for i in starts)
    return hits / max(len(starts), 1)


def staged_gates(protocol: str, ates: dict, recall: float) -> dict:
    """The gates of ``protocol`` on the stage ATEs ``ates`` (odometry a0,
    loops a1, BA on one device a2, and ``ba_mesh`` where BA also ran on a
    mesh) and the revisit recall: gate name -> held."""
    a0, a1, a2 = ates["odometry"], ates["loops"], ates["ba"]
    if protocol == "staged128":
        gates = {"a1 < 0.6 a0": a1 < 0.6 * a0, "a2 < a1": a2 < a1}
    else:
        a2g, where = (ates["ba_mesh"], "mesh") if "ba_mesh" in ates else (a2, "one")
        gates = {"recall >= 0.8": recall >= 0.8, "a1 < 0.7 a0": a1 < 0.7 * a0,
                 f"a2({where}) <= 1.05 a1": a2g <= 1.05 * a1}
    if "ba_mesh" in ates:
        a2m = ates["ba_mesh"]
        gates["|a2(mesh) - a2(one)| < 0.3 max"] = abs(a2m - a2) < MESH_TOL * max(a2m, a2)
    return gates


def run(frames: int = 256, *, laps: int = 4, protocol: str = "f256",
        mesh_devices: Optional[Sequence] = None, device="cuda",
        seq: Optional[Tuple[np.ndarray, List[np.ndarray]]] = None,
        max_keypoints: int = 512) -> Iterator[dict]:
    """The evaluation of ``frames`` frames and ``laps`` laps under
    ``protocol`` (one of :data:`PROTOCOLS`), with BA also on a mesh of
    ``mesh_devices`` where given (see the module's docstring).  ``seq``
    supplies ``vo_bench.sequence``'s (poses, frames); its poses must be this
    circuit's (raises ValueError), so a longer rendered circuit's first
    frames serve when the laps scale with it.  Yields the loop record, one
    record a stage, the dispatch record, then the summary with its gates."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"protocol {protocol!r} is not one of {PROTOCOLS}")
    dev, card = _common.start(device)
    gt = render.loop_trajectory(frames, radius=2.0, laps=laps)
    if seq is None:
        seq = vo_bench.sequence(frames, laps=laps)
    elif not np.array_equal(seq[0], gt):
        raise ValueError(f"seq is not the {frames}-frame circuit of {laps} laps")
    imgs = seq[1]
    height, width = imgs[0].shape
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    cam = vo_bench.render_config(width, height).camera()
    mesh = None if mesh_devices is None else meshlib.make_mesh(devices=mesh_devices)
    if protocol == "staged128":  # tests/test_render_vo.py:218-242
        vocfg = slam.VOConfig(max_keypoints=max_keypoints, camera=cam, loop_ratio_mad_max=0.15,
                              loop_edge_weight=0.3, loop_edge_min_gap=(3 * frames) // 8)
        propose = dict(gap=10)
    else:  # tools/exp_r5_f256_mesh.py:56-109
        vocfg = vo_bench.vo_config(frames, cam, max_keypoints)
        propose = dict(gap=10, top_k=8, min_matches=120)
    tag = f"{frames} frames, {laps} laps, {width}x{height}, K={max_keypoints}"

    def pct(poses: np.ndarray) -> float:
        return 100.0 * slam.evaluate_ate(poses, gt) / traj

    def stage(name: str, fn, **extra) -> Tuple[object, dict]:
        out, sec, stage_peak, peak = _common.timed_stage(fn, dev)
        rec = {"stage": name, "sec": sec, "stage_peak_bytes": stage_peak,
               "process_peak_bytes": peak, **extra}
        if isinstance(out, np.ndarray):
            rec["ate_pct"] = pct(out)
        _common.log(f"{tag}: {name} {sec:.2f} s" + (f", ATE {rec['ate_pct']:.3f}%"
                                                    if "ate_pct" in rec else ""))
        return out, dict(rec, device=card)

    feats, rec_f = stage("features", lambda: slam.frontend_features(imgs, vocfg, device=dev))
    (pd, loops), rec_l = stage("matches + loop proposal", lambda: (
        slam.frontend_matches(imgs, vocfg, features=feats, device=dev),
        slam.propose_loop_closures(imgs, vocfg, features=feats, device=dev, **propose)))
    rec_l.update(features_sec=rec_f["sec"], features_stage_peak_bytes=rec_f["stage_peak_bytes"],
                 features_process_peak_bytes=rec_f["process_peak_bytes"],
                 loops_proposed=len(loops), propose=propose,
                 revisit_recall=revisit_recall(loops, frames, laps))
    yield rec_l

    est0, rec = stage("odometry", lambda: slam.run_vo_matches(pd, vocfg, device=dev))
    yield rec
    mets, it = [], {}
    est1, rec = stage("loops", lambda: slam.run_vo_matches(pd, vocfg, loop_pairs=loops,
                                                           metrics=mets, _internals=it,
                                                           device=dev))
    rec.update(loops_accepted=sum(1 for m in mets if m.get("loop_closure")),
               loop_edges=sum(1 for m in mets if m.get("edge_added")),
               loop_links=len(it["loop_links"]))
    yield rec
    ba_args = (it["graph_poses"], it["batch"], it["est"])
    ba_kw = dict(loop_links=it["loop_links"] or None, graph_edges=it["rot_edges"], device=dev)
    ates = {"odometry": pct(est0), "loops": pct(est1)}
    if mesh is not None:
        _, rec = stage("ba_mesh", lambda: slam.refine_with_ba(*ba_args, mesh=mesh, **ba_kw),
                       mesh=repr(mesh))
        ates["ba_mesh"] = rec["ate_pct"]
        yield rec
    _, rec = stage("ba", lambda: slam.refine_with_ba(*ba_args, **ba_kw))
    ates["ba"] = rec["ate_pct"]
    yield rec

    g = it["graph"]
    eager_pose_graph = precision.matmul_highest(posegraph._steps)
    has_loops = g.edge_i.numel() > frames - 1
    yield {"stage": "dispatch",
           "refine_with_ba": _common.dispatch_counts(
               lambda: slam.refine_with_ba(*ba_args, **ba_kw), dev),
           # The eager path, which a loop graph's key takes once a run:
           # three calls of ``optimize`` in a row would capture its graph.
           "pose_graph": _common.dispatch_counts(lambda: eager_pose_graph(
               g, vocfg.loop_pose_graph_iters if has_loops else vocfg.pose_graph_iters, "dense",
               50, 1e-6, vocfg.loop_robust_delta if has_loops else 0.0, flags=False), dev),
           "pose_graph_poses": frames, "pose_graph_edges": int(g.edge_i.numel()),
           "device": card}

    gates = staged_gates(protocol, ates, rec_l["revisit_recall"])
    _common.log(f"{tag}: ATE % {ates}; gates {gates}")
    yield {"stage": f"{protocol}_f{frames}" + ("" if mesh is None else "_mesh"),
           "protocol": protocol, "frames": frames, "laps": laps, "ate_pct": ates,
           "gates": gates, "ok": all(gates.values()), "jax_bound_pct": JAX_BOUND_PCT,
           "under_jax_bound": {k: ates[k] < JAX_BOUND_PCT for k in ("ba_mesh", "ba") if k in ates},
           "device": card}


def main(argv=None) -> int:
    ap = _common.parser(__doc__)
    ap.add_argument("frames", nargs="?", type=int, default=256, help="frames (default 256)")
    ap.add_argument("--protocol", choices=PROTOCOLS, default="f256",
                    help="the JAX evaluation whose configuration and gates to run (default f256)")
    ap.add_argument("--mesh", type=int, default=8,
                    help="BA also on a mesh of the device repeated N times (default 8); 0: no mesh")
    args = ap.parse_args(argv)
    last = None
    for rec in run(args.frames, laps=max(1, args.frames // 64), protocol=args.protocol,
                   mesh_devices=[args.device] * args.mesh if args.mesh else None,
                   device=args.device):
        _common.print_records([rec])
        last = rec
    return 0 if last["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
