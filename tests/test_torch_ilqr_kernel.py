"""Kernel K5 (the whole AL-iLQR solve) on the CPU, float64: its body
(``csrc/bodies.cuh`` ``ilqr_team`` on ``csrc/press_dual.cuh``, built for
the host by ``g++ -O2 -ffp-contract=off``) against the plain version
(``solver/riccati.py`` in tensor code) and the JAX package's
``riccati.solve_batch``.

Cases: N = 5, 10 and 25, ``p_max`` None (nc = 2) and 32e6 (nc = 4), the
three model variants, the trace, cold and warm starts, on the scenarios of
the iLQR parity test (tests/test_torch_riccati.py) and on ties of the
physics (y > 0 with y_dot = 0 on the forging force's gate; a working
pressure on the orifice's kink), plus a stage whose AL residual sits
exactly at the max(., 0) kink; and N = 30 and 40, past the cap of 25 that
the kernel had before its blocks moved to shared memory, with the 6 x 2
rounds of the ``teacher_6x2`` preset (p_max None at N = 30, 32e6 at
N = 40), the trace at N = 30, where scenarios converge and the kernel
skips the iterations that repeat a step not taken. Bounds: u0, v and lam within 1e-9
of the plain version (the smoke run's card-against-CPU bound), the other
diagnostics at the parity test's bounds; against the JAX package, the
parity test's bounds. At N = 30 and 40 the JAX package and the plain path
on the CPU part from each other beyond 1e-9 in none of the five scenarios
(share 0), so no case here needs the share rule that the card's checks
apply at N = 25 and 30. The team's partition changes no bit: every team
size gives the same outputs. Then the closed loop through both kernels (K5
and K4 on the host) against the JAX package's, the dispatch rules, the
shared-memory layout and its horizon limit, and the wrapper's refusals.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_kernels as hk
from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.solver import riccati as jriccati
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.ops import build, ilqr
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.refgen import streams
from forging_control_tpu_torch.solver import riccati

PS, EPS_Q = press.DEFAULT_PARAMS.PS, press.DEFAULT_PARAMS.eps_q
XS = np.array([[0.0, 0.0, 2156275.6006012624, 2961363.827545376, 0.0],
               [0.03, 0.4, 8e6, 4e6, 0.1],
               [0.08, 0.3, 2e5, 9e6, 0.07],          # p1 near its bound
               [0.03, 0.0, 8e6, 4e6, 0.05],          # y > 0, y_dot = 0
               [0.02, 0.1, PS - EPS_Q / 2, 4e6, 0.02]])  # on the kink
REFS = np.array([0.578157, 0.4, -0.5, 0.3, -0.2])
UPS = np.array([0.0, 0.05, 0.05, 0.02, -0.01])

CASES = {
    "N5_trace_smooth": jsqp.MPCConfig(horizon=5, variant="smooth", gn_iters=3,
                                      al_iters=2, record_trace=True),
    "N10_pmax_raw": jsqp.MPCConfig(horizon=10, variant="raw", gn_iters=3,
                                   al_iters=2, p_max=32e6),
    "N25_clamp": jsqp.MPCConfig(horizon=25, variant="clamp", gn_iters=2,
                                al_iters=2),
    "N10_fast_pmax_trace": jsqp.MPCConfig.fast(
        horizon=10, gn_iters=5, variant="smooth", p_max=32e6,
        record_trace=True),
    "N30_teacher_trace": jsqp.MPCConfig(horizon=30, variant="smooth",
                                        gn_iters=6, al_iters=2,
                                        record_trace=True),
    "N40_teacher_pmax": jsqp.MPCConfig(horizon=40, variant="smooth",
                                       gn_iters=6, al_iters=2, p_max=32e6),
}


def _nc(cfg):
    return 2 if cfg.p_max is None else 4


@functools.lru_cache(maxsize=None)
def _jax_runs(case):
    """The JAX package's cold solve, then a warm solve from its shifted
    solution at perturbed states; inputs and outputs as NumPy."""
    cfg = CASES[case]
    N, B = cfg.horizon, len(XS)
    run = jax.jit(lambda x, r, u, s: jriccati.solve_batch(cfg, x, r, u, s))
    cold = jriccati.ILQRState(v=jnp.zeros((B, N)),
                              lam=jnp.zeros((B, N, _nc(cfg))))
    out_cold = run(jnp.asarray(XS), jnp.asarray(REFS), jnp.asarray(UPS), cold)
    warm = jax.vmap(jriccati.shift_state)(out_cold[1])
    xs_w = XS * (1.0 + 0.01 * np.random.default_rng(N).standard_normal(
        XS.shape))
    ups_w = np.array(out_cold[0])
    out_warm = run(jnp.asarray(xs_w), jnp.asarray(REFS), jnp.asarray(ups_w),
                   warm)
    as_np = lambda tree: jax.tree.map(np.array, tree)  # noqa: E731
    return {"cold": (XS, UPS, as_np(cold), as_np(out_cold)),
            "warm": (xs_w, ups_w, as_np(warm), as_np(out_warm))}


def _port_cfg(jcfg):
    return interop.mpc_config_from_dict(dataclasses.asdict(jcfg))


def _assert_solved_close(out, u, st, d, *, uv_atol=1e-9):
    """K5's outputs against a plain solve (u, state, Diagnostics)."""
    np.testing.assert_allclose(out.u0.numpy(), np.asarray(u), rtol=0,
                               atol=uv_atol)
    np.testing.assert_allclose(out.v.numpy(), np.asarray(st.v), rtol=0,
                               atol=uv_atol)
    np.testing.assert_allclose(out.lam.numpy(), np.asarray(st.lam), rtol=0,
                               atol=uv_atol)
    np.testing.assert_array_equal(out.iters.numpy(), np.asarray(d.iters))
    np.testing.assert_allclose(out.obj.numpy(), np.asarray(d.obj),
                               rtol=1e-9, atol=1e-12)
    for f in ("inf_pr", "inf_du"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(d, f)), rtol=1e-7,
                                   atol=1e-12)
    np.testing.assert_allclose(out.d_norm.numpy(), np.asarray(d.d_norm),
                               rtol=1e-9, atol=1e-11)
    for f in ("reg", "mu", "alpha"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(d, f)), rtol=1e-12)
    if d.trace is None:
        assert out.trace is None
    else:
        np.testing.assert_allclose(out.trace.numpy(), np.asarray(d.trace),
                                   rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("start", ["cold", "warm"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_ilqr_host_matches_plain_and_jax(case, start):
    xs, ups, state0, want = _jax_runs(case)[start]
    cfg = _port_cfg(CASES[case])
    x0, ref, up, v, lam = hk.float64(xs, REFS, ups, state0.v, state0.lam)
    out = hk.solve_host(cfg, x0, ref, up, v, lam)
    u, st, d = riccati.solve_batch(cfg, x0, ref, up,
                                   riccati.ILQRState(v, lam))
    _assert_solved_close(out, u, st, d)
    ju, jst, jd = want
    # The parity test's bounds (tests/test_torch_riccati.py).
    np.testing.assert_allclose(out.u0.numpy(), ju, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out.v.numpy(), jst.v, rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(out.lam.numpy(), jst.lam, rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_array_equal(out.iters.numpy(), jd.iters)
    np.testing.assert_allclose(out.obj.numpy(), jd.obj, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(out.alpha.numpy(), jd.alpha, rtol=1e-12)
    if cfg.record_trace:
        assert out.trace.shape == (len(XS), cfg.al_iters * cfg.gn_iters, 6)
        np.testing.assert_allclose(out.trace.numpy(), jd.trace, rtol=1e-7,
                                   atol=1e-12)
    if start == "cold" and cfg.p_max is None:
        assert st.lam[2].max() > 0       # the bound is active: AL at work
    if case == "N30_teacher_trace":      # steps not taken, then repeats
        assert (out.trace[:, 1:, 3] == 0).any()


# The team's partition at G = 16 and 32, where the rollouts run on quads
# of four lanes (rhs_four), against G = 8's one-lane rollouts (aug_step):
# N = 1 to 30, the three variants, p_max, the trace on and off, float64
# and (N = 10, fast_5x1) float32.
QUAD_CASES = {
    "N1_smooth_trace": riccati.MPCConfig(horizon=1, variant="smooth",
                                         gn_iters=3, al_iters=2,
                                         record_trace=True),
    "N5_raw_pmax": riccati.MPCConfig(horizon=5, variant="raw", gn_iters=3,
                                     al_iters=2, p_max=32e6),
    "N10_fast_f32_trace": riccati.MPCConfig.fast(
        horizon=10, gn_iters=5, variant="smooth", record_trace=True),
    "N25_clamp": riccati.MPCConfig(horizon=25, variant="clamp", gn_iters=2,
                                   al_iters=2),
    "N30_teacher_pmax_trace": riccati.MPCConfig(
        horizon=30, variant="smooth", gn_iters=6, al_iters=2, p_max=32e6,
        record_trace=True),
}


def _quad_inputs(case, start):
    """The iLQR parity scenarios, cold (zeros) or warm (the cold solve's
    shifted solution from states moved by 1 %), on the CPU."""
    cfg = QUAD_CASES[case]
    N, B = cfg.horizon, len(XS)
    dtype = torch.float32 if "f32" in case else torch.float64
    x0, ref, up = (torch.as_tensor(a, dtype=dtype) for a in (XS, REFS, UPS))
    v = torch.zeros(B, N, dtype=dtype)
    lam = torch.zeros(B, N, _nc(cfg), dtype=dtype)
    if start == "warm":
        cold = hk.solve_host(cfg, x0, ref, up, v, lam)
        st = riccati.shift_state(riccati.ILQRState(cold.v, cold.lam))
        move = np.random.default_rng(N).standard_normal(XS.shape)
        x0 = torch.as_tensor(XS * (1.0 + 0.01 * move), dtype=dtype)
        up, v, lam = cold.u0, st.v.contiguous(), st.lam.contiguous()
    return cfg, (x0, ref, up, v, lam)


@pytest.mark.parametrize("team,case,start", [
    *(pytest.param(t, None, "warm", id=str(t))
      for t in ilqr.TEAMS if t != ilqr.TEAM),
    *(pytest.param(t, case, start, id=f"{t}-{case}-{start}")
      for t in (16, 32) for case in QUAD_CASES for start in ("cold", "warm"))])
def test_torch_ilqr_host_same_bits_for_every_team(team, case, start):
    """Every value is computed by one lane in one order, whatever the team
    size, and at G = 16 and 32 the quads' rollouts (rhs_four) give
    aug_step's bits: the outputs at each G equal the default team's bit
    for bit.  (case None: the JAX package's warm start at N = 25.)"""
    if case is None:
        xs, ups, state0, _ = _jax_runs("N25_clamp")["warm"]
        cfg = _port_cfg(CASES["N25_clamp"])
        args = hk.float64(xs, REFS, ups, state0.v, state0.lam)
    else:
        cfg, args = _quad_inputs(case, start)
    want = hk.solve_host(cfg, *args)
    got = hk.solve_host(cfg, *args, team=team)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("N", [10, 25])
def test_torch_ilqr_team_size_rule(N):
    """The team size from the batch on a card of 132 SMs (an H100): the
    largest G of 32 and 16 whose one wave holds the batch, else 8; 8 in
    float64 whatever the batch."""
    f32, f64 = torch.float32, torch.float64
    assert ilqr.resident_teams(N, f32, 32) == 8
    assert ilqr.resident_teams(N, f32, 16) == 16
    assert ilqr.resident_teams(N, f32, 8) == {10: 32, 25: 16}[N]
    want = {1: 32, 256: 32, 1024: 32, 1056: 32, 1057: 16, 2048: 16,
            2112: 16, 2113: 8, 4096: 8}
    for B, G in want.items():
        assert ilqr.team_size(B, N, f32, 132) == G, B
        assert ilqr.team_size(B, N, f64, 132) == ilqr.TEAM
    assert ilqr.team_size(1, N, f32, 1) == 32
    assert ilqr.team_size(9, N, f32, 1) == 16


def test_torch_ilqr_shared_layout_and_horizon_limit():
    """The wrapper's size of a scenario's blocks is the body's
    (IlqrLayout, and the candidates' states in device memory); the horizon
    limit is the largest N whose blocks fit the 227 KB a block may use (at
    least 200 in float64); the teams a block holds fill one warp, fewer
    where the shared memory runs out."""
    lib = hk.lib()
    for N in (*range(1, 60), 267, 268, 536, 537):
        assert ilqr.team_fields(N) == lib.fct_ilqr_team_fields(N)
        assert ilqr.team_fields(N) % 2 == 1
        assert ilqr.zc_fields(N) == lib.fct_ilqr_zc_fields(N)
    for dtype, size, limit in ((torch.float32, 4, 536),
                               (torch.float64, 8, 267)):
        N = ilqr.max_horizon(dtype)
        assert N == limit and (dtype == torch.float32 or N >= 200)
        assert ilqr.team_fields(N) * size <= ilqr.SHARED_BYTES \
            < ilqr.team_fields(N + 1) * size
    assert ilqr.teams_per_block(10, torch.float32, 8) == 4
    assert ilqr.teams_per_block(25, torch.float64, 4) == 8
    assert ilqr.teams_per_block(40, torch.float64, 4) == 6
    assert ilqr.teams_per_block(267, torch.float64, 4) == 1


def test_torch_ilqr_host_al_residual_at_its_kink():
    """p_min set to the exact working pressure that the warm start's
    rollout reaches at stage 1, with zero multipliers: the stage-1 AL
    residual max(lam / mu - c, 0) is evaluated at 0 - 0, its tie (half the
    tangent to each side, as in JAX)."""
    base = riccati.MPCConfig(horizon=6, variant="smooth", gn_iters=3,
                             al_iters=2)
    x0, ref, up = hk.float64(XS[1:2], REFS[1:2], UPS[1:2])
    v = torch.full((1, 6), 2.0, dtype=torch.float64)
    zs, _ = riccati._rollout_batch(base, x0, up / riccati.U_SCALE, v)
    cfg = dataclasses.replace(base, p_min=float(zs[0, 1, 2]))
    lam = torch.zeros(1, 6, 2, dtype=torch.float64)
    c = riccati._constraints(cfg, zs[:, 1, :5])
    assert float(c[0, 0]) == 0.0
    out = hk.solve_host(cfg, x0, ref, up, v, lam)
    u, st, d = riccati.solve_batch(cfg, x0, ref, up, riccati.ILQRState(v, lam))
    _assert_solved_close(out, u, st, d)


@pytest.mark.parametrize("variant", ["raw", "smooth", "clamp"])
def test_torch_ilqr_host_float32_commands_near_plain(variant):
    """float32 through the same body: the commands within 1e-4 of the plain
    version's (bench.py's kernel check bound)."""
    cfg = riccati.MPCConfig.fast(horizon=10, gn_iters=5, variant=variant)
    x0, ref, up = (a.float() for a in hk.float64(XS, REFS, UPS))
    st = riccati.ILQRState(torch.zeros(len(XS), 10),
                           torch.zeros(len(XS), 10, 2))
    out = hk.solve_host(cfg, x0, ref, up, st.v, st.lam)
    u, _, _ = riccati.solve_batch(cfg, x0, ref, up, st)
    assert out.u0.dtype == torch.float32 and torch.isfinite(out.u0).all()
    assert float((out.u0 - u).abs().max()) <= 1e-4


def test_torch_ilqr_polish_after_the_kernel(monkeypatch):
    """With polish_iters the kernel runs the rounds and solve_batch polishes
    after it in tensor code, as the plain path does."""
    cfg = riccati.MPCConfig(horizon=5, variant="smooth", gn_iters=3,
                            al_iters=2, polish_iters=2)
    x0, ref, up = hk.float64(XS, REFS, UPS)
    st = riccati.ILQRState(torch.zeros(len(XS), 5, dtype=torch.float64),
                           torch.zeros(len(XS), 5, 2, dtype=torch.float64))
    u_p, st_p, d_p = riccati.solve_batch(cfg, x0, ref, up, st)
    counts = hk.route_kernels_to_host(monkeypatch)
    u_k, st_k, d_k = riccati.solve_batch(cfg, x0, ref, up, st)
    assert counts["ilqr"] == 1
    np.testing.assert_allclose(u_k.numpy(), u_p.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(st_k.v.numpy(), st_p.v.numpy(), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(d_k.obj.numpy(), d_p.obj.numpy(), rtol=1e-9)
    np.testing.assert_allclose(d_k.inf_pr.numpy(), d_p.inf_pr.numpy(),
                               rtol=1e-7, atol=1e-12)


# The closed loop of tests/test_torch_closed_loop.py, iLQR backend.
LB, LN, LT = 3, 5, 6
LOOP = jcl.LoopConfig(t_steps=LT, variant="smooth",
                      process_std=(5e-1, 2e0, 5e7, 5e7, 2e0))
LCFG = jsqp.MPCConfig(horizon=LN, variant="smooth", gn_iters=2, al_iters=1)


@functools.lru_cache(maxsize=None)
def _jax_loop():
    ctrl = jcl.MPCController(LCFG, backend="ilqr")
    x0 = jnp.tile(jnp.asarray(jcl.press.X0_REFERENCE, jnp.float64), (LB, 1))
    refs = jstreams.reference_table(LB, "supervised", t_steps=2 * LT)
    _, telem = jax.jit(lambda x, r, k: jcl.run_batch(LOOP, ctrl, x, r, k))(
        x0, jnp.asarray(refs[:, LT // 2:LT // 2 + LT]), jax.random.PRNGKey(7))
    return dataclasses.asdict(ctrl), jax.tree.map(np.array, telem)


def test_torch_closed_loop_through_both_kernels_matches_jax(monkeypatch):
    """The slice as a whole: run_batch with the AL-iLQR controller, every
    period's solve through K5 and its plant step through K4 (their bodies
    on the CPU), against the JAX package's closed loop at the closed-loop
    parity test's bounds; each kernel launched once a period."""
    ctrl_d, want = _jax_loop()
    ctrl = interop.mpc_controller_from_dict(ctrl_d)
    loop_cfg = interop.loop_config_from_dict(dataclasses.asdict(LOOP))
    x0 = np.tile(np.array(press.X0_REFERENCE), (LB, 1))
    refs = streams.reference_table(LB, "supervised", t_steps=2 * LT)
    counts = hk.route_kernels_to_host(monkeypatch)
    x_final, telem = cl.run_batch(loop_cfg, ctrl, x0,
                                  refs[:, LT // 2:LT // 2 + LT],
                                  process_noise=want.w, device="cpu")
    assert dict(counts) == {"plant": LT, "ilqr": LT}
    got = interop.telemetry_to_numpy(telem)
    np.testing.assert_allclose(got["u"], want.u, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["x"], want.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["Fd"], want.Fd, rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(got["diag"]["iters"], want.diag.iters)
    np.testing.assert_allclose(got["diag"]["obj"], want.diag.obj, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got["diag"]["inf_du"], want.diag.inf_du,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(x_final.numpy()[:, 1], want.x[:, -1, 1],
                               rtol=1e-9, atol=1e-9)


def test_torch_ilqr_dispatch_rules(monkeypatch):
    """A CPU state runs the plain version whatever ``solver`` says; a card
    runs K5 for "kernel" and the tensor code for "plain"; other devices and
    solvers raise; the closed loop's graph key tells the two apart."""
    cfg = riccati.MPCConfig(horizon=4, variant="smooth", gn_iters=2,
                            al_iters=1)
    x0, ref, up = hk.float64(XS, REFS, UPS)
    st = riccati.ILQRState(torch.zeros(len(XS), 4, dtype=torch.float64),
                           torch.zeros(len(XS), 4, 2, dtype=torch.float64))
    launches = build.LAUNCHES.copy()
    a = riccati.solve_batch(cfg, x0, ref, up, st)
    b = riccati.solve_batch(cfg, x0, ref, up, st, solver="plain")
    assert build.LAUNCHES == launches
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].v, b[1].v)
    with pytest.raises(ValueError, match="unknown solver"):
        riccati.solve_batch(cfg, x0, ref, up, st, solver="pallas")
    with pytest.raises(ValueError, match="unsupported device"):
        riccati.solve_batch(cfg, x0, ref, up, riccati.ILQRState(
            st.v.to("meta"), st.lam.to("meta")))

    counts = hk.route_kernels_to_host(monkeypatch)
    riccati.solve_batch(cfg, x0, ref, up, st, solver="plain")
    assert counts["ilqr"] == 0
    riccati.solve_batch(cfg, x0, ref, up, st)
    assert counts["ilqr"] == 1
    kernel = cl.MPCController(cfg, backend="ilqr")
    plain = cl.MPCController(cfg, backend="ilqr", linsolve="plain")
    kernel.step_batch(kernel.init_carry_batch(len(XS), torch.float64, "cpu"),
                      x0, ref, up)
    assert counts["ilqr"] == 2
    plain.step_batch(plain.init_carry_batch(len(XS), torch.float64, "cpu"),
                     x0, ref, up)
    assert counts["ilqr"] == 2
    key = functools.partial(cl._graph_key, cl.LoopConfig(), n_batch=4,
                            dtype=torch.float32, device="cpu")
    assert key(controller=kernel) != key(controller=plain)


def test_torch_ilqr_wrapper_refuses_what_the_kernel_does_not_take():
    cfg = riccati.MPCConfig(horizon=5)
    x0, ref, up = hk.float64(XS, REFS, UPS)
    v = torch.zeros(len(XS), 5, dtype=torch.float64)
    lam = torch.zeros(len(XS), 5, 2, dtype=torch.float64)
    kcfg = riccati.kernel_cfg(cfg, 5)
    with pytest.raises(ValueError, match="cuda tensors"):
        ilqr.ilqr_cuda(riccati.kernel_cfg(cfg, 5), cfg.params, x0, ref, up, v,
                       lam)
    with pytest.raises(TypeError, match="float32 or float64"):
        ilqr.check(kcfg, x0.half(), ref.half(), up.half(), v.half(),
                   lam.half(), "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        ilqr.check(kcfg, x0.float(), ref, up, v, lam, "cpu")
    over = ilqr.max_horizon(torch.float64) + 1
    with pytest.raises(ValueError, match=f"N <= {over - 1} "):
        ilqr.check(riccati.kernel_cfg(cfg, over), x0, ref, up,
                   torch.zeros(len(XS), over, dtype=torch.float64),
                   torch.zeros(len(XS), over, 2, dtype=torch.float64), "cpu")
    with pytest.raises(ValueError, match="team must be one of"):
        ilqr.check(kcfg, x0, ref, up, v, lam, "cpu", team=12)
    with pytest.raises(ValueError, match="team must be one of"):
        ilqr.check(kcfg, x0, ref, up, v, lam, "cpu", team=4)
    with pytest.raises(ValueError, match="lam has shape"):
        ilqr.check(riccati.kernel_cfg(dataclasses.replace(cfg, p_max=32e6),
                                      5), x0, ref, up, v, lam, "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        ilqr.check(kcfg, x0.t().contiguous().t(), ref, up, v, lam, "cpu")
    with pytest.raises(RuntimeError, match="backward"):
        ilqr.check(kcfg, x0, ref, up, v.requires_grad_(True), lam, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        build.on_card(torch.device("meta"))
