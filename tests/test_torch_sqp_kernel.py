"""The condensed GN-SQP's build and search kernels on the CPU: their bodies
(``csrc/sqp_bodies.cuh`` on ``csrc/press_dual.cuh``, built for the host by
``g++ -O2 -ffp-contract=off``) with B1's plain version between them, driven
through ``solver.sqp.solve_batch``'s kernel path and the wrappers' checks
and argument packing (``tests/torch_host_kernels.py``), against the plain
solve (``linsolve="plain"``, the tensor code).

Cases: a cold start, a hot start across the stroke reversal (the warm start
of a work-stroke solve, then a negative reference), ``p_max`` set with two
AL rounds and the trace, a 3-rung ladder, the clamp variant at N = 12 and
N = 25 from a warm start, each in float64 and float32.  Bounds: float64
u0, v and lam within 1e-9 and the same iteration counts; float32 u0 within
1e-4, a tenth of ``benchmark/check.py``'s SQP limits.  Then: the team's
partition changes no bit; two candidates of equal cost go to the lower
index, as ``torch.argmin``; rounds without a Gauss-Newton iteration and the
polish; the closed loop's period through the kernels (launches, no host
data, no sync); the dispatch rule and the wrappers' refusals.
"""

import collections
import functools

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_host_kernels as hk
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.ops import build, smallchol
from forging_control_tpu_torch.ops import sqp as sqp_ops
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import sqp

PS, EPS_Q = press.DEFAULT_PARAMS.PS, press.DEFAULT_PARAMS.eps_q
XS = np.array([[0.0, 0.0, 2156275.6006012624, 2961363.827545376, 0.0],
               [0.03, 0.4, 8e6, 4e6, 0.1],
               [0.08, 0.3, 2e5, 9e6, 0.07],          # p1 near its bound
               [0.03, 0.0, 8e6, 4e6, 0.05],          # y > 0, y_dot = 0
               [0.02, 0.1, PS - EPS_Q / 2, 4e6, 0.02]])  # on the kink
REFS = np.array([0.578157, 0.4, -0.5, 0.3, -0.2])
UPS = np.array([0.0, 0.05, 0.05, 0.02, -0.01])

CASES = {
    "cold_fast_N10": (sqp.MPCConfig.fast(horizon=10, gn_iters=5,
                                         variant="smooth"), "cold"),
    "reversal_fast_N10": (sqp.MPCConfig.fast(horizon=10, gn_iters=5,
                                             variant="smooth"), "reversal"),
    "pmax_al2_trace_N10": (sqp.MPCConfig(horizon=10, gn_iters=3, al_iters=2,
                                         p_max=32e6, variant="smooth",
                                         record_trace=True), "cold"),
    "ladder3_N2": (sqp.MPCConfig(horizon=2, variant="raw",
                                 step_ladder=(1.0, 0.5, 0.25)), "cold"),
    "clamp_N12": (sqp.MPCConfig.fast(horizon=12, gn_iters=4,
                                     variant="clamp"), "warm"),
    "warm_N25": (sqp.MPCConfig(horizon=25, gn_iters=3, al_iters=1,
                               variant="smooth"), "warm"),
}


def _tensors(dtype, *arrays):
    return tuple(torch.as_tensor(a, dtype=dtype).contiguous()
                 for a in arrays)


def _kernel_solve(cfg, x0, ref, up, state, **kw):
    """solve_batch through the kernels' bodies on the CPU."""
    mp = pytest.MonkeyPatch()
    try:
        counts = hk.route_kernels_to_host(mp)
        out = sqp.solve_batch(cfg, x0, ref, up, state, **kw)
    finally:
        mp.undo()
    return out, counts


@functools.lru_cache(maxsize=None)
def _inputs(case, dtype_name):
    """(x0, ref, u_prev, SolverState) of a case: zeros (cold); inputs
    ~ 0.05 N(0, 1) and multipliers ~ 0.1 |N(0, 1)| (warm); or the shifted
    solution of a work-stroke solve at positive references, then the
    negated references from perturbed states (reversal)."""
    cfg, start = CASES[case]
    dtype = getattr(torch, dtype_name)
    N, B = cfg.horizon, len(XS)
    rng = np.random.default_rng(N)
    x0, ref, up = XS, REFS, UPS
    v, lam = np.zeros((B, N)), np.zeros((B, cfg.n_con))
    if start == "warm":
        v = 0.05 * rng.standard_normal((B, N))
        lam = 0.1 * np.abs(rng.standard_normal((B, cfg.n_con)))
    if start == "reversal":
        work = _tensors(dtype, XS, np.abs(REFS), UPS)
        (u, st, _), _ = _kernel_solve(cfg, *work, sqp.SolverState(
            *_tensors(dtype, v, lam)))
        st = sqp.shift_state(st)
        x0 = XS * (1.0 + 0.01 * rng.standard_normal(XS.shape))
        x0[:, 1] = np.abs(x0[:, 1])            # still moving down
        ref, up, v, lam = -np.abs(REFS), u.numpy(), st.v.numpy(), \
            st.lam.numpy()
    x0, ref, up, v, lam = _tensors(dtype, x0, ref, up, v, lam)
    return x0, ref, up, sqp.SolverState(v, lam)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(got.double().numpy(), want.double().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", list(CASES))
def test_torch_sqp_kernels_match_plain(case, dtype):
    cfg, _ = CASES[case]
    x0, ref, up, state = _inputs(case, dtype)
    (u, st, d), counts = _kernel_solve(cfg, x0, ref, up, state)
    u_p, st_p, d_p = sqp.solve_batch(cfg, x0, ref, up, state,
                                     linsolve="plain")
    n = cfg.gn_iters * cfg.al_iters
    assert counts == collections.Counter(sqp_build=n, smallchol=n,
                                         sqp_search=n)
    assert all(bool(torch.isfinite(a).all()) for a in (u, st.v, st.lam))
    if dtype == "float32":
        _close(u, u_p, 1e-4)
        return
    for got, want in ((u, u_p), (st.v, st_p.v), (st.lam, st_p.lam)):
        _close(got, want, 1e-9)
    assert torch.equal(d.iters, d_p.iters)
    _close(d.obj, d_p.obj, 1e-12, 1e-9)
    for f in ("inf_pr", "inf_du"):
        _close(getattr(d, f), getattr(d_p, f), 1e-12, 1e-7)
    for f in ("d_norm", "alpha"):
        _close(getattr(d, f), getattr(d_p, f), 1e-9)
    assert torch.equal(d.mu, d_p.mu) and torch.equal(d.reg, d_p.reg)
    assert (d.trace is None) == (d_p.trace is None)
    if d.trace is not None:
        _close(d.trace, d_p.trace, 1e-9, 1e-7)


@pytest.mark.parametrize("build_team,search_team", [(16, 1), (32, 32)])
def test_torch_sqp_kernels_team_changes_no_bit(build_team, search_team,
                                               monkeypatch):
    """The build at G = N (the default), 16 and 32 lanes, the search at a
    lane per candidate (the default), one lane and 32: the same bits."""
    cfg, _ = CASES["pmax_al2_trace_N10"]
    x0, ref, up, state = _inputs("pmax_al2_trace_N10", "float64")
    want, _ = _kernel_solve(cfg, x0, ref, up, state)
    monkeypatch.setattr(sqp_ops, "build_team", lambda N: build_team)
    monkeypatch.setattr(sqp_ops, "search_team", lambda n: search_team)
    got, _ = _kernel_solve(cfg, x0, ref, up, state)
    for a, b in zip((got[0], *got[1], *got[2]), (want[0], *want[1],
                                                 *want[2])):
        assert torch.equal(a, b)


def test_torch_sqp_search_breaks_a_tie_toward_the_lower_index():
    """B1's solutions made so that candidate 1 (the ladder's 0.5 along the
    first step) and candidate 2 (1.0 along the second step, half the
    first) are the same point: equal costs, and the search takes index 1
    (alpha 0.5), as torch.argmin does on the plain costs."""
    cfg = sqp.MPCConfig(horizon=4, variant="smooth", gn_iters=1, al_iters=1,
                        step_ladder=(1.0, 0.5))
    x0, ref, up, state = _inputs("cold_fast_N10", "float64")
    state = sqp.SolverState(state.v[:, :4].contiguous(),
                            torch.zeros(len(XS), cfg.n_con,
                                        dtype=torch.float64))
    kcfg = sqp.kernel_cfg(cfg, 4)
    bufs = sqp_ops.allocate(kcfg, state.v)
    step = sqp_ops.schedule(1, 1)[0]
    hk.sqp_build_host(kcfg, cfg.params, x0, ref, up, state.v, state.lam,
                      bufs, step)
    x = smallchol.chol_solve_torch(bufs.H, bufs.g)
    x = torch.stack([2 * x[:, 0], x[:, 0], 10 * x[:, 0]], dim=1)
    hk.sqp_search_host(kcfg, cfg.params, x0, ref, up, state.v, state.lam, x,
                       bufs, step)
    # The plain line search on the same candidates.
    alphas = torch.tensor([1.0, 0.5, 1.0, 1.0], dtype=torch.float64)
    dirs = -torch.stack([x[:, 0], x[:, 0], x[:, 1], x[:, 2]], dim=1)
    vs = state.v[:, None] + alphas[None, :, None] * dirs
    B, C = vs.shape[:2]
    mu = torch.full((), cfg.mu0, dtype=torch.float64)
    r, _ = sqp._residuals(cfg, x0[:, None].expand(B, C, 5),
                          ref[:, None].expand(B, C),
                          (up / sqp.U_SCALE)[:, None].expand(B, C),
                          state.lam[:, None].expand(B, C, cfg.n_con), mu, vs)
    costs = 0.5 * torch.sum(r * r, dim=-1)
    assert torch.equal(vs[:, 1], vs[:, 2]) and torch.equal(costs[:, 1],
                                                           costs[:, 2])
    best = torch.argmin(costs, dim=1)
    assert int((best == 1).sum()) >= 3          # the tie decides most
    took = bufs.out.d_norm > 0
    want_alpha = torch.where(took, alphas[best], 0.0)
    assert torch.equal(bufs.out.alpha, want_alpha)
    _close(bufs.out.v, torch.where(took[:, None],
                                   vs[torch.arange(B), best], state.v), 1e-12)


def test_torch_sqp_rounds_without_gauss_newton_and_polish():
    """gn_iters = 0 (the AL update at the warm start alone), al_iters = 0
    (the diagnostics alone) and the polish after the kernels, against the
    plain solve."""
    x0, ref, up, _ = _inputs("cold_fast_N10", "float64")
    rng = np.random.default_rng(3)
    for cfg in (sqp.MPCConfig(horizon=5, gn_iters=0, al_iters=2),
                sqp.MPCConfig(horizon=5, al_iters=0),
                sqp.MPCConfig(horizon=5, gn_iters=2, al_iters=1, p_max=32e6,
                              polish_iters=2)):
        state = sqp.SolverState(*_tensors(
            torch.float64, 0.05 * rng.standard_normal((len(XS), 5)),
            0.1 * np.abs(rng.standard_normal((len(XS), cfg.n_con)))))
        (u, st, d), counts = _kernel_solve(cfg, x0, ref, up, state)
        u_p, st_p, d_p = sqp.solve_batch(cfg, x0, ref, up, state,
                                         linsolve="plain")
        n = cfg.gn_iters * cfg.al_iters
        assert counts["smallchol"] == n
        assert counts["sqp_build"] == counts["sqp_search"] == max(
            n, cfg.al_iters if cfg.gn_iters == 0 else 1)
        for got, want in ((u, u_p), (st.v, st_p.v), (st.lam, st_p.lam),
                          (d.obj, d_p.obj), (d.inf_pr, d_p.inf_pr),
                          (d.d_norm, d_p.d_norm), (d.inf_du, d_p.inf_du)):
            _close(got, want, 1e-9)
        for f in ("iters", "mu", "alpha", "reg"):
            assert torch.equal(getattr(d, f), getattr(d_p, f)), f


class _SyncCounter(TorchDispatchMode):
    """Counts the ops that make a tensor from host data or synchronise."""

    SYNCING = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith(self.SYNCING):
            self.found[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_torch_sqp_kernel_period_launches_and_never_syncs(monkeypatch):
    """The closed loop's period with the SQP controller through the kernels
    (bodies on the CPU), float32 as on the card: a build, B1 and a search
    a Gauss-Newton iteration and K4 once, no host-data tensor, no scalar
    read; and run_batch through them agrees with the plain loop."""
    counts = hk.route_kernels_to_host(monkeypatch)
    cfg = sqp.MPCConfig.fast(horizon=10, gn_iters=5, variant="smooth")
    loop = cl.LoopConfig(t_steps=3, variant="smooth",
                         process_std=(5e-4, 2e-3, 5e4, 5e4, 2e-3))
    ctrl = cl.MPCController(cfg)
    B = 4
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).repeat(B, 1)
    x0[:, 1] = torch.linspace(0.0, 0.2, B, dtype=torch.float64)
    carry = cl.StepperCarry(
        x_true=x0.float(), x_meas=press.measure(x0, loop.params,
                                                loop.variant).float(),
        ctrl=ctrl.init_carry_batch(B, torch.float32, "cpu"),
        u_prev=torch.zeros(B))
    ref, w = torch.full((B,), 0.3), torch.full((B, 5), 1e-3)
    body = functools.partial(cl._period, loop, ctrl)
    body(carry, (ref, w, w))                   # warm-up
    before = counts.copy()
    counter = _SyncCounter()
    with counter:
        body(carry, (ref, w, w))
    assert dict(counter.found) == {}
    assert counts - before == collections.Counter(
        plant=1, sqp_build=5, smallchol=5, sqp_search=5)
    # The loop (float64) from the reference state, as the datasets start,
    # kernels against the plain loop.
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).repeat(B, 1)
    refs = torch.from_numpy(np.random.default_rng(4).uniform(0.05, 0.5,
                                                             (B, 3)))
    noise = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 3, 5)) * np.array(loop.process_std))
    run = functools.partial(cl.run_batch, loop, x0=x0, refs=refs,
                            process_noise=noise, device="cpu")
    _, tel_k = run(ctrl)
    _, tel_p = run(cl.MPCController(cfg, linsolve="plain"))
    _close(tel_k.u, tel_p.u, 1e-9)
    _close(tel_k.x, tel_p.x, 1e-9, 1e-9)


def test_torch_sqp_dispatch_rules(monkeypatch):
    """On the CPU both linsolves run the tensor code (no launch, the same
    bits); on a card "kernel" runs the kernels, "plain" the tensor code,
    and what the kernels cannot run raises (no fallback); unknown
    linsolves and devices raise; the graph key tells the two apart."""
    cfg = sqp.MPCConfig(horizon=4, variant="smooth", gn_iters=2, al_iters=1)
    x0, ref, up, _ = _inputs("cold_fast_N10", "float64")
    state = sqp.SolverState(torch.zeros(len(XS), 4, dtype=torch.float64),
                            torch.zeros(len(XS), 8, dtype=torch.float64))
    launches = build.LAUNCHES.copy()
    a = sqp.solve_batch(cfg, x0, ref, up, state)
    b = sqp.solve_batch(cfg, x0, ref, up, state, linsolve="plain")
    assert build.LAUNCHES == launches
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].v, b[1].v)
    with pytest.raises(ValueError, match="unknown linsolve"):
        sqp.solve_batch(cfg, x0, ref, up, state, linsolve="pallas")
    with pytest.raises(ValueError, match="unsupported device"):
        sqp.solve_batch(cfg, x0, ref, up, sqp.SolverState(
            state.v.to("meta"), state.lam.to("meta")))

    counts = hk.route_kernels_to_host(monkeypatch)
    sqp.solve_batch(cfg, x0, ref, up, state, linsolve="plain")
    assert counts["sqp_build"] == counts["sqp_search"] == 0
    sqp.solve_batch(cfg, x0, ref, up, state)
    assert counts["sqp_build"] == counts["sqp_search"] == 2
    assert counts["smallchol"] == 2
    big = sqp.MPCConfig(horizon=26, gn_iters=1, al_iters=1)
    with pytest.raises(ValueError, match="N <= 25"):
        sqp.solve_batch(big, x0, ref, up, sqp.SolverState(
            torch.zeros(len(XS), 26, dtype=torch.float64),
            torch.zeros(len(XS), 52, dtype=torch.float64)))
    kernel = cl.MPCController(cfg)
    plain = cl.MPCController(cfg, linsolve="plain")
    key = functools.partial(cl._graph_key, cl.LoopConfig(), n_batch=4,
                            dtype=torch.float32, device="cpu")
    assert key(controller=kernel) != key(controller=plain)


def test_torch_sqp_wrappers_refuse_what_the_kernels_do_not_take():
    cfg = sqp.MPCConfig(horizon=5)
    x0, ref, up, _ = _inputs("cold_fast_N10", "float64")
    v = torch.zeros(len(XS), 5, dtype=torch.float64)
    lam = torch.zeros(len(XS), 10, dtype=torch.float64)
    kcfg = sqp.kernel_cfg(cfg, 5)
    bufs = sqp_ops.allocate(kcfg, v)
    step = sqp_ops.schedule(1, 1)[0]
    with pytest.raises(ValueError, match="cuda tensors"):
        sqp_ops.sqp_build_cuda(kcfg, cfg.params, x0, ref, up, v, lam, bufs,
                               step)
    with pytest.raises(ValueError, match="cuda tensors"):
        sqp_ops.sqp_search_cuda(kcfg, cfg.params, x0, ref, up, v, lam,
                                bufs.g, bufs, step)
    check = functools.partial(sqp_ops.check, device_type="cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        check(kcfg, x0.half(), ref.half(), up.half(), v.half(), lam.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        check(kcfg, x0.float(), ref, up, v, lam)
    with pytest.raises(ValueError, match="lam has shape"):
        check(sqp.kernel_cfg(sqp.MPCConfig(horizon=5, p_max=32e6), 5), x0,
              ref, up, v, lam)
    with pytest.raises(ValueError, match="horizon"):
        check(sqp.kernel_cfg(cfg, 6), x0, ref, up, v, lam)
    with pytest.raises(ValueError, match="contiguous"):
        check(kcfg, x0.t().contiguous().t(), ref, up, v, lam)
    with pytest.raises(RuntimeError, match="backward"):
        check(kcfg, x0, ref, up, v.clone().requires_grad_(True), lam)
    with pytest.raises(ValueError, match="at most 62 rungs"):
        sqp.kernel_cfg(sqp.MPCConfig(horizon=5, step_ladder=(0.5,) * 63), 5)
    with pytest.raises(ValueError, match="team must lie in 5..32"):
        sqp_ops._team(4, 5, 5)
    # The team follows what the kernels see: a lane an input direction in
    # the build, a lane a candidate in the search, teams packed in a warp.
    assert [sqp_ops.build_team(N) for N in (1, 10, 25)] == [1, 10, 25]
    assert [sqp_ops.teams_per_block(G) for G in (1, 10, 16, 25, 32)] == [
        32, 3, 2, 1, 1]
    assert [sqp_ops.search_team(n) for n in (3, 4, 40)] == [3, 4, 32]
    assert build.on_card(torch.device("cpu")) is False


def test_torch_sqp_schedule():
    """The launches of a solve: a build, B1 and a search a Gauss-Newton
    iteration, the flags of the first, the rounds' last and the last; a
    build and a search without a step where a round or the solve has no
    Gauss-Newton iteration."""
    S = sqp_ops.Step
    F, T, E, L = sqp_ops.FIRST, sqp_ops.STEP, sqp_ops.ROUND_END, sqp_ops.LAST
    assert sqp_ops.schedule(1, 3) == (S(0, -1, F | T), S(0, -1, T),
                                      S(0, -1, T | E | L))
    assert sqp_ops.schedule(2, 1, True) == (S(0, 0, F | T | E),
                                            S(1, 1, T | E | L))
    assert sqp_ops.schedule(2, 0) == (S(0, -1, F | E), S(1, -1, E | L))
    assert sqp_ops.schedule(0, 4) == (S(0, -1, F | L),)
