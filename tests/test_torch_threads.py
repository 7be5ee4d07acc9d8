"""The port's geometry called from several threads at once.

Forward-mode AD levels are process-wide in torch, not per thread, so every
forward-mode transform of the port (``ba._jacobians``' ``jacfwd``,
``posegraph``'s dense ``jacfwd`` and its CG ``jvp``) runs under the one
re-entrant lock ``lie.FORWARD_AD``.  Four threads each run
``posegraph.optimize`` several times on a 24-pose float64 chain, with both
solvers, beside threads that form ``ba._jacobians``: no thread raises, and
each result equals the single-thread run's bit for bit.

``precision.tf32_off`` changes a process-wide setting; with a lock and a
depth count the first entry (in any thread) saves the caller's setting and
the last exit restores it.  Both interleavings of two threads' guards are
run from "high" (TF32 on): full precision inside every guard, "high" after
both exit; nesting in one thread keeps working.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from feature_detector_fast_tpu_torch.models import ba, lie, posegraph
from feature_detector_fast_tpu_torch.utils import precision

N_POSES = 24
THREADS = 4
RUNS = 4
JOIN_S = 60.0


def chain(seed: int = 0) -> posegraph.PoseGraph:
    """A noisy 24-pose odometry chain with one loop edge, float64."""
    rng = np.random.default_rng(seed)
    xi = np.zeros((N_POSES, 6))
    xi[:, 0] = 0.5
    xi[:, 5] = 2 * np.pi / N_POSES
    step = lie.se3_exp(torch.from_numpy(xi + rng.normal(0, 0.02, xi.shape)))
    poses = [torch.eye(4, dtype=torch.float64)]
    for k in range(N_POSES - 1):
        poses.append(poses[-1] @ step[k])
    poses = torch.stack(poses)
    ei = torch.tensor(list(range(N_POSES - 1)) + [N_POSES - 1])
    ej = torch.tensor(list(range(1, N_POSES)) + [0])
    meas = lie.se3_exp(torch.from_numpy(np.tile(xi[:1], (N_POSES, 1))))
    return posegraph.PoseGraph(poses, ei, ej, meas, torch.ones(N_POSES, dtype=torch.bool),
                               torch.ones(N_POSES, dtype=torch.float64))


def ba_problem(seed: int = 1) -> ba.BAProblem:
    rng = np.random.default_rng(seed)
    n_cams, n_pts = 4, 30
    poses = lie.se3_exp(torch.from_numpy(rng.normal(0, 0.1, (n_cams, 6))))
    points = torch.from_numpy(np.stack([rng.uniform(-1, 1, n_pts), rng.uniform(-1, 1, n_pts),
                                        rng.uniform(4, 8, n_pts)], -1))
    cams = torch.arange(n_cams).repeat_interleave(n_pts)
    lms = torch.arange(n_pts).repeat(n_cams)
    uv = ba.project(poses[cams], points[lms]) + 1e-3
    return ba.BAProblem(poses, points, cams, lms, uv, torch.ones(cams.shape[0], dtype=torch.bool),
                        n_fixed_cams=1)


def run_threads(targets):
    """Start one thread per callable, join each within JOIN_S under a short
    switch interval; returns (results, errors) by thread index."""
    results = [None] * len(targets)
    errors = []

    def wrap(i, fn):
        try:
            results[i] = fn()
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=wrap, args=(i, fn), daemon=True)
                   for i, fn in enumerate(targets)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
        assert not any(t.is_alive() for t in threads), "a thread did not finish"
    finally:
        sys.setswitchinterval(old)
    return results, errors


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_posegraph_optimize_in_threads(solver):
    g = chain()
    want, want_cost = posegraph.optimize(g, 3, solver, 12)

    def work():
        return [posegraph.optimize(g, 3, solver, 12) for _ in range(RUNS)]

    results, errors = run_threads([work] * THREADS)
    assert not errors, errors
    for runs in results:
        for poses, cost in runs:
            assert torch.equal(poses, want) and torch.equal(cost, want_cost)


def test_ba_jacobians_beside_posegraph_threads():
    """ba's jacfwd and posegraph's jvp in threads at once: one lock for both."""
    p, g = ba_problem(), chain()
    want_j = ba._jacobians(p, 0.01)
    want_pg = posegraph.optimize(g, 3, "cg", 12)

    def jac():
        return [ba._jacobians(p, 0.01) for _ in range(RUNS)]

    def pg():
        return [posegraph.optimize(g, 3, "cg", 12) for _ in range(RUNS)]

    results, errors = run_threads([jac, pg, jac, pg])
    assert not errors, errors
    for i, runs in enumerate(results):
        want = want_j if i % 2 == 0 else want_pg
        for got in runs:
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_forward_ad_lock_is_reentrant():
    p = ba_problem()
    with lie.FORWARD_AD:
        r, jc, jl = ba._jacobians(p)
    assert jc.shape == (120, 2, 6) and jl.shape == (120, 2, 3) and torch.isfinite(r).all()


@pytest.fixture()
def tf32_high():
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)


@pytest.mark.parametrize("first_out", ["A", "B"])
def test_tf32_off_two_threads(tf32_high, first_out):
    """A enters, B enters, then ``first_out`` exits first; the other thread
    reads the precision inside its guard after that exit."""
    a_in, b_in, first_done = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def guarded(name, entered, wait_for):
        with precision.tf32_off():
            seen[name + " entered"] = torch.get_float32_matmul_precision()
            entered.set()
            assert wait_for.wait(JOIN_S)
            if name != first_out:
                assert first_done.wait(JOIN_S)
                seen[name + " after the other's exit"] = torch.get_float32_matmul_precision()
        if name == first_out:
            first_done.set()

    def thread_b():
        assert a_in.wait(JOIN_S)
        guarded("B", b_in, b_in)

    _, errors = run_threads([lambda: guarded("A", a_in, b_in), thread_b])
    assert not errors, errors
    assert seen == {"A entered": "highest", "B entered": "highest",
                    ("B" if first_out == "A" else "A") + " after the other's exit": "highest"}
    assert torch.get_float32_matmul_precision() == "high"


def test_tf32_off_nested_in_one_thread(tf32_high):
    @precision.matmul_highest
    def inner():
        return torch.get_float32_matmul_precision()

    @precision.matmul_highest
    def outer():
        got = [inner(), torch.get_float32_matmul_precision()]
        with precision.tf32_off():
            got.append(inner())
        got.append(torch.get_float32_matmul_precision())
        return got

    assert outer() == ["highest"] * 4
    assert torch.get_float32_matmul_precision() == "high"
    with pytest.raises(ValueError):
        with precision.tf32_off():
            with precision.tf32_off():
                raise ValueError("inside")
    assert torch.get_float32_matmul_precision() == "high"
