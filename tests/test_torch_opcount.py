"""The operation counts of kernels K4 and K5 and of the SQP's build and
search (``ops.opcount``): their bodies on the CPU on the counting scalar of
``csrc/op_count.h``, and K4's longest dependent chain.

The counted run computes what the host build computes, bit for bit, and
its count does not depend on how the scenarios are split over threads.
The count leaves out what the function does not need: the forging force
costs its 44 operations only where its gate is open, and the AL-iLQR solve
costs less on the return stroke, where that gate stays shut.
"""

import numpy as np
import pytest
import torch

import torch_host_kernels as hk
from forging_control_tpu_torch import bench
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.ops import opcount, plant, smallchol
from forging_control_tpu_torch.ops import sqp as sqp_ops
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.physics.scaling import U_SCALE
from forging_control_tpu_torch.solver import riccati, sqp


def _plant_inputs(B, seed):
    rng = np.random.default_rng(seed)
    lo = np.array([-0.02, -0.9, -3e6, -3e6, -0.25])
    hi = np.array([0.15, 0.9, 3.5e7, 3.5e7, 0.25])
    x = lo + (hi - lo) * rng.random((B, 5))
    u = rng.uniform(-0.25, 0.25, B)
    w = rng.standard_normal((B, 5)) * np.array([5e-4, 2e-3, 5e4, 5e4, 2e-3])
    v = rng.standard_normal((B, 5)) * np.array([1e-5, 1e-4, 1e4, 1e4, 1e-4])
    return hk.float64(x, x, u, w, v)


@pytest.mark.parametrize("variant", ["raw", "smooth", "clamp"])
def test_torch_opcount_plant_outputs_equal_host_build(variant):
    """Both bodies (team 1: plant_body; 4: the team body)."""
    hk.lib()
    cfg = cl.LoopConfig(variant=variant, state_clip=(0.12, 0.6, 3.3e7,
                                                     3.3e7, 0.2))
    t = _plant_inputs(24, 1)
    for team in plant.TEAMS:
        outs, one = opcount.plant_ops(cfg, *t, threads=1, team=team)
        for got, want in zip(outs, hk.plant_host(cfg, *t, team=team)):
            assert torch.equal(got, want)
        _, three = opcount.plant_ops(cfg, *t, threads=3, team=team)
        assert one == three and one["total"] > 0
        assert sum(one["by_phase"].values()) == one["total"]


# K4's operations and dependent chain at a fixed input (_plant_inputs(24,
# 1), float64, the state clip), as the one-thread body plant_body gives
# them: the count is the function's (the bound's numerator), which the
# kernel's body may not move.  Its depth is the longest chain of counted
# operations to any output.
PINNED_PLANT = {
    "raw": (32455, {"forging force": 352, "RK4": 31743,
                    "clip and measurement": 360},
            {"forging force": 23, "RK4": 269, "clip and measurement": 272}),
    "smooth": (36527, {"forging force": 352, "RK4": 35575,
                       "clip and measurement": 600},
               {"forging force": 23, "RK4": 278,
                "clip and measurement": 286}),
    "clamp": (33215, {"forging force": 352, "RK4": 32503,
                      "clip and measurement": 360},
              {"forging force": 23, "RK4": 269, "clip and measurement": 272}),
}


@pytest.mark.parametrize("variant", ["raw", "smooth", "clamp"])
def test_torch_opcount_plant_pinned_count_and_depth(variant):
    """plant_body's count by phase and depth by phase at the pinned input;
    the kernel's body (every G) reaches the same depth: its selects wait
    for both sides, and the deepest chain is a branch that the pinned
    input takes anyway.  The team body runs more operations than the
    function needs (both sides of every select, and each lane's part)."""
    hk.lib()
    cfg = cl.LoopConfig(variant=variant, state_clip=(0.12, 0.6, 3.3e7,
                                                     3.3e7, 0.2))
    t = _plant_inputs(24, 1)
    total, by_phase, depth = PINNED_PLANT[variant]
    _, counts = opcount.plant_ops(cfg, *t)
    assert counts["total"] == total and counts["by_phase"] == by_phase
    assert counts["depth"] == {
        "period": max(depth.values()), "by_phase": depth,
        "per_stage": depth["RK4"] / 16}
    _, executed = opcount.plant_ops(cfg, *t, team=4)
    assert executed["depth"] == counts["depth"]
    assert executed["total"] > total


def test_torch_opcount_forging_force_only_where_its_gate_opens():
    """press.forging_force in values, counted by hand: clip of y (2),
    max of y_dot (1), H0 - y_s (1), w1 (H0 / h1 as a reciprocal and a
    product 2, pow 1, times W0 1), b1 (8), Kd (8), Ad (1), e (H0 - y_s 1,
    H0 / . 2, log 1, max 1), e_dot (2), its floor (1) and the product of
    the seven factors with exp(M4 / e) (11): 44, and 0 where y <= 0 or
    y_dot < 0."""
    hk.lib()
    cfg = cl.LoopConfig(variant="smooth")
    x_true, x_meas, u, w, v = _plant_inputs(16, 2)
    x_meas[:, 0] = torch.linspace(-0.01, 0.12, 16, dtype=torch.float64)
    x_meas[:, 1] = torch.tensor([0.2, -0.1] * 8, dtype=torch.float64)
    x_meas[3, 0], x_meas[3, 1] = 0.05, 0.0        # y_dot = 0: open
    is_open = (x_meas[:, 0] > 0) & (x_meas[:, 1] >= 0)
    _, counts = opcount.plant_ops(cfg, x_true, x_meas, u, w, v)
    assert counts["by_phase"]["forging force"] == 44 * int(is_open.sum())
    assert 0 < int(is_open.sum()) < 16


@pytest.mark.parametrize("p_max,trace", [(None, True), (32e6, False)],
                         ids=["nc2_trace", "nc4"])
def test_torch_opcount_ilqr_outputs_equal_host_build(p_max, trace):
    hk.lib()
    cfg = riccati.MPCConfig(horizon=5, variant="smooth", gn_iters=3,
                            al_iters=2, p_max=p_max, record_trace=trace)
    B = 6
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).repeat(B, 1)
    ref = torch.linspace(-0.8, 0.6, B, dtype=torch.float64)
    up = torch.zeros(B, dtype=torch.float64)
    nc = 2 if p_max is None else 4
    v = torch.zeros(B, 5, dtype=torch.float64)
    lam = torch.zeros(B, 5, nc, dtype=torch.float64)
    kcfg = riccati.kernel_cfg(cfg, 5)
    out, one = opcount.ilqr_ops(kcfg, cfg.params, x0, ref, up, v, lam,
                                threads=1)
    want = hk.solve_host(cfg, x0, ref, up, v, lam)
    for got, w in zip(out, want):
        assert (got is None) == (w is None)
        if got is not None:
            assert torch.equal(got, w)
    _, two = opcount.ilqr_ops(kcfg, cfg.params, x0, ref, up, v, lam,
                              threads=2)
    assert one == two
    assert all(n > 0 for n in one["by_phase"].values())


def test_torch_opcount_ilqr_return_stroke_needs_less():
    """With negative references the press retracts and the forging force's
    gate stays shut, so the solve needs fewer operations than with the
    same references made positive."""
    hk.lib()
    cfg = bench.PRESETS["fast_5x1"](horizon=10, variant="smooth")
    B = 8
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float32).repeat(B, 1)
    ref = torch.linspace(0.1, 0.6, B)
    up = torch.zeros(B)
    v, lam = torch.zeros(B, 10), torch.zeros(B, 10, 2)
    kcfg = riccati.kernel_cfg(cfg, 10)
    _, work = opcount.ilqr_ops(kcfg, cfg.params, x0, ref, up, v, lam)
    _, back = opcount.ilqr_ops(kcfg, cfg.params, x0, -ref, up, v, lam)
    assert back["total"] < work["total"]
    assert (back["by_phase"]["backward sweep"]
            == work["by_phase"]["backward sweep"])


# K5's operation count at a fixed input, as its one-thread body gave it
# (B = 64, N = 10, fast_5x1, float32, the cold start at the reference state,
# references drawn from default_rng(10) in [0.05, 0.65], negated for the
# return stroke): the bound's numerator is the function's count, which no
# partition of the body over lanes may move.
PINNED_ILQR_OPS = {
    "work": {"total": 67276590, "by_phase": {
        "initial rollout": 1028544, "stage RK4 with tangents": 39354752,
        "residuals and Gauss-Newton blocks": 85120,
        "backward sweep": 2566400, "forward sweep": 24221790,
        "accept, AL update and diagnostics": 19984}},
    "return": {"total": 49003255, "by_phase": {
        "initial rollout": 1028544, "stage RK4 with tangents": 27805827,
        "residuals and Gauss-Newton blocks": 85120,
        "backward sweep": 2566400, "forward sweep": 17496180,
        "accept, AL update and diagnostics": 21184}},
}


@pytest.mark.parametrize("stroke", ["work", "return"])
def test_torch_opcount_ilqr_pinned_to_the_one_thread_body(stroke):
    """The function's count equals the one-thread body's at the pinned
    input, before the body was split over lanes.  What the kernel runs
    differs: more in the linearisation (each tangent group evaluates its
    stage's values again), and nothing of an iteration that repeats the
    last one, which it skips."""
    hk.lib()
    cfg = bench.PRESETS["fast_5x1"](horizon=10, variant="smooth")
    B = 64
    refs = np.random.default_rng(10).uniform(0.05, 0.65, B)
    sign = 1.0 if stroke == "work" else -1.0
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float32).repeat(B, 1)
    ref = torch.tensor(sign * refs, dtype=torch.float32)
    v, lam = torch.zeros(B, 10), torch.zeros(B, 10, 2)
    _, counts = opcount.ilqr_ops(riccati.kernel_cfg(cfg, 10), cfg.params, x0,
                                 ref, torch.zeros(B), v, lam, executed=True)
    executed = counts.pop("executed")
    assert counts == PINNED_ILQR_OPS[stroke]
    rk4 = "stage RK4 with tangents"
    assert executed["by_phase"][rk4] > counts["by_phase"][rk4]
    assert all(executed["by_phase"][k] <= n
               for k, n in counts["by_phase"].items() if k != rk4)


def test_torch_opcount_ilqr_function_count_whatever_the_team():
    """The function's count is the one-lane body's at every team size; what
    the kernel runs at G = 32 differs only in the rollouts (the initial one
    and the forward sweep), which its quads run on K4's four-lane rhs."""
    hk.lib()
    cfg = bench.PRESETS["fast_5x1"](horizon=5, variant="smooth")
    B = 4
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float32).repeat(B, 1)
    ref = torch.linspace(-0.5, 0.6, B)
    v, lam = torch.zeros(B, 5), torch.zeros(B, 5, 2)
    runs = {G: opcount.ilqr_ops(riccati.kernel_cfg(cfg, 5), cfg.params, x0,
                                ref, torch.zeros(B), v, lam, executed=True,
                                team=G) for G in (8, 32)}
    (out8, c8), (out32, c32) = runs[8], runs[32]
    for a, b in zip(out8, out32):
        assert (a is None and b is None) or torch.equal(a, b)
    e8, e32 = c8.pop("executed"), c32.pop("executed")
    assert c8 == c32
    rollouts = ("initial rollout", "forward sweep")
    for k, n in e8["by_phase"].items():
        assert (e32["by_phase"][k] > n) if k in rollouts \
            else e32["by_phase"][k] == n


def _sqp_launch(cfg, B, ref):
    """The first Gauss-Newton iteration of a cold SQP solve from the
    reference state, float64: (kernel configuration, inputs, buffers,
    step)."""
    N = cfg.horizon
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).repeat(B, 1)
    ref = torch.as_tensor(ref, dtype=torch.float64).expand(B).contiguous()
    up = torch.zeros(B, dtype=torch.float64)
    v = torch.zeros(B, N, dtype=torch.float64)
    lam = torch.zeros(B, cfg.n_con, dtype=torch.float64)
    kcfg = sqp.kernel_cfg(cfg, N)
    step = sqp_ops.schedule(cfg.al_iters, cfg.gn_iters, cfg.record_trace)[0]
    return kcfg, (x0, ref, up, v, lam), sqp_ops.allocate(kcfg, v), step


@pytest.mark.parametrize("p_max", [None, 32e6], ids=["nc2_trace", "nc4"])
def test_torch_opcount_sqp_outputs_equal_host_build(p_max):
    """The counted build and search write what the host build writes,
    bit for bit, and count the same on one thread as on three."""
    hk.lib()
    cfg = sqp.MPCConfig(horizon=5, variant="smooth", gn_iters=2,
                        al_iters=1, p_max=p_max, record_trace=p_max is None)
    kcfg, t, bufs, step = _sqp_launch(cfg, 6, np.linspace(-0.8, 0.6, 6))
    step = step._replace(flags=step.flags | sqp_ops.ROUND_END
                         | sqp_ops.LAST)
    def zeroed(b):      # one launch writes one trace row of two
        if b.out.trace is not None:
            b.out.trace.zero_()
        return b

    bufs = zeroed(bufs)
    counted = {}
    for threads in (1, 3):
        b = zeroed(sqp_ops.allocate(kcfg, t[3]))
        cb = opcount.sqp_build_ops(kcfg, cfg.params, *t, b, step, threads)
        x = smallchol.chol_solve_torch(b.H, b.g)
        cs = opcount.sqp_search_ops(kcfg, cfg.params, *t, x, b, step,
                                    threads)
        counted[threads] = (cb, cs, b)
    hk.sqp_build_host(kcfg, cfg.params, *t, bufs, step)
    x = smallchol.chol_solve_torch(bufs.H, bufs.g)
    hk.sqp_search_host(kcfg, cfg.params, *t, x, bufs, step)
    got = counted[1][2]
    for a, w in zip((got.H, got.g, got.work, got.cs, *got.out),
                    (bufs.H, bufs.g, bufs.work, bufs.cs, *bufs.out)):
        assert (a is None) == (w is None)
        if a is not None:
            assert torch.equal(a, w)
    assert counted[1][:2] == counted[3][:2]
    assert all(n > 0 for n in counted[1][0]["by_phase"].values())


def _rk4_ops(xs, us):
    """K4's count of its RK4 phase (plant_body, the function's count) for
    one period from each state of xs (R, 5) at the commands us (R,)."""
    loop = cl.LoopConfig(variant="smooth")
    _, counts = opcount.plant_ops(loop, xs, xs, us, None, None, threads=1)
    return counts["by_phase"]["RK4"]


def test_torch_opcount_sqp_hand_count_at_n2():
    """The build's and the search's counts at N = 2 (fast_5x1, nc = 2,
    one scenario from the reference state, a cold start, the first
    Gauss-Newton iteration), counted by hand where they are not physics;
    their rollouts' physics is K4's count of the same periods.

    Build, a lane per direction i (lane 0 also sums).  Residual rows a
    lane: u_prev's scaling (1); a stage: y_dot - ref, du, sqrt(rterm) du
    (3), each pressure over its scale (1; minus p_lo = 0 is free) and its
    tangent where direction i has reached stage k (1), each AL row
    (lam / mu, minus c, max, times sqrt(mu / 2): 4; the constraints are
    inactive, so their tangents are structural zeros): 13 + 2 [k >= i];
    lane 0's sums: 3 + 6 over the stages' squares (track, du, raw du),
    3 + 6 over the AL rows' squares and the largest -c; so
    (1 + 15 + 15) + 18 + (1 + 13 + 15) = 78, and with the values once
    (less lane 1's 1 + 13 + 13) 51.  Normal equations: g_0 over the rows
    (track0, track1, du0, du1: 4 products, 3 adds; the AL rows' tangents
    are zero) 7, g_1 (track1, du1) 3, H_00 5 + 3 dampings, H_01 2, H_11
    2 + 3: 25.  Cost (3 adds, a half), objective (2), infeasibility (1)
    and the largest |g| (2 abs, 1 max): 10.  A lane's values (what lane 1
    computes again): the RK4 is K4's count of the two periods along v and
    the input's scaling (v U_SCALE, 1 a stage), the residual rows 1 + 13
    + 13.  The function's count (one lane, every direction) does not
    depend on the kernel's team.

    Search, a candidate a lane: steps (v + alpha d, its square into the
    norm: 2 at stage 0 and 3 after, one more a stage where alpha is not
    1): 5 + 7 + 5 + 5 = 22; residuals and costs a candidate: u_prev's
    scaling 1, stage 0 19 (3 rows, 3 squares, 2 pressures, 8 AL, 3 AL
    squares and max), stage 1 25, then the cost (4), the norm's root (1),
    the objective (2) and the infeasibility (1): 53, 212 for four; the new
    iterate N (1 + [alpha != 1]); the RK4 K4's count of the candidates'
    periods and their inputs' scaling (1 a stage)."""
    hk.lib()
    cfg = sqp.MPCConfig.fast(horizon=2, gn_iters=5, variant="smooth")
    kcfg, t, bufs, step = _sqp_launch(cfg, 1, 0.3)
    x0, ref, up, v, lam = t
    cb = opcount.sqp_build_ops(kcfg, cfg.params, *t, bufs, step, threads=1)
    fn, vals = cb["function"]["by_phase"], cb["values"]["by_phase"]
    assert [cb["by_phase"][p] for p in opcount.SQP_BUILD_PHASES[1:]] == [
        78, 25, 10]
    assert [fn[p] for p in opcount.SQP_BUILD_PHASES[1:]] == [51, 25, 10]
    xs = sqp._rollout(cfg, x0, v)[0]                       # (N, 5)
    rk4 = opcount.SQP_BUILD_PHASES[0]
    assert vals[rk4] == _rk4_ops(torch.cat([x0, xs[:-1]]),
                                 v[0] * U_SCALE) + 2
    assert vals[opcount.SQP_BUILD_PHASES[1]] == 1 + 13 + 13
    # The function's count does not depend on the kernel's team.
    other = opcount.sqp_build_ops(kcfg, cfg.params, *t,
                                  sqp_ops.allocate(kcfg, v), step,
                                  threads=1, team=16)
    assert other["function"] == cb["function"]
    assert other["total"] == cb["total"]


    x = smallchol.chol_solve_torch(bufs.H, bufs.g)
    cs = opcount.sqp_search_ops(kcfg, cfg.params, *t, x, bufs, step,
                                threads=1)
    alphas = torch.tensor([1.0, 0.25, 1.0, 1.0], dtype=torch.float64)
    dirs = -x[0][[0, 0, 1, 2]]
    vs = v + alphas[:, None] * dirs                         # (4, N)
    states = sqp._rollout(cfg, x0.expand(4, 5), vs)
    starts = torch.cat([x0.expand(4, 1, 5), states[:, :-1]], 1)
    taken = float(bufs.out.d_norm[0]) > 0
    best_alpha = float(bufs.out.alpha[0])
    assert cs["by_phase"] == {
        "candidates' steps": 22, "RK4": _rk4_ops(
            starts.reshape(-1, 5), (vs * U_SCALE).reshape(-1)) + 4 * 2,
        "residuals and costs": 212,
        "accept, AL update and diagnostics":
            2 * (1 + (best_alpha != 1.0)) if taken else 0}
