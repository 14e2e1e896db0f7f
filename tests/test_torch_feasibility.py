"""The port's feasibility recovery against the JAX package (float64, CPU),
and the cases of ``tests/test_feasibility.py`` on the port.

``recover`` and ``recover_warm`` run on 64 seeded states, half of them near
the pressure bounds, against the JAX package's (``jit(vmap(...))``): ``u``
within rtol 1e-9 / atol 1e-12 (the SQP parity scale of
``tests/test_torch_sqp.py``), ``violation`` and ``lam`` within rtol 1e-7 /
atol 1e-12.

Near ties.  The projection takes discrete decisions: the best of 7 seeds,
the best of 3 step candidates, and whether that candidate lowers the cost.
Close to convergence the costs compared there differ by a few units in the
last place of a cost of order 1e2, which is below the rounding difference
between XLA's and PyTorch's evaluation of the physics; the two packages can
then decide differently, and their commands differ by about one late
Gauss-Newton step (1e-9 to 1e-8).  The test replays the port's decisions
(``_replay``, held bitwise to the port's result) and reports every state
that met a decision whose two sides lay within 1e-12 of each other
(relative to the cost); a state outside the tolerance must be one of those,
and there its command must agree within the largest step decided by such a
tie.  Near ties are common (most states that converge meet one in their
last steps), but few decide differently: those that do (their commands
differ by more than 1e-13) are reported and may be at most half of the
states; every other state is held to the full tolerances (they agree to
about 1e-14).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.solver import feasibility as jfeas
from forging_control_tpu_torch import dual as ad
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import feasibility as feas

CFG = feas.FeasibilityConfig()
JCFG = jfeas.FeasibilityConfig()
CAVITATION = (0.08, 0.15, 2e5, 9e6, 0.05)   # tests/test_feasibility.py
TIE = 1e-12                                  # relative gap of a near tie
N_STATES = 64


def _states():
    rng = np.random.RandomState(0)
    B = N_STATES
    x = np.stack([rng.uniform(0, 0.1, B), rng.uniform(-0.6, 0.6, B),
                  rng.uniform(1e5, 3.1e7, B), rng.uniform(1e5, 3.1e7, B),
                  rng.uniform(-0.2, 0.2, B)], -1)
    # Half of them at pressures near the bounds, where the projection acts.
    x[B // 2:, 2] = rng.uniform(-5e5, 1e6, B // 2)
    x[B // 2:, 3] = rng.uniform(3.0e7, 3.3e7, B // 2)
    x[0], x[1] = CAVITATION, press.X0_REFERENCE
    u = rng.uniform(-0.3, 0.3, B)
    u[0], u[1] = -0.2, 0.03
    warm_u = rng.uniform(-0.2, 0.2, B)
    warm_lam = np.abs(rng.randn(B, 8)) * (rng.rand(B, 8) < 0.3)
    return x, u, warm_u, warm_lam


@functools.lru_cache(maxsize=None)
def _jax_results():
    x, u, wu, wl = _states()

    def both(uu, xx, w_u, w_l):
        cold = jfeas.recover(JCFG, uu, xx)
        warm, new = jfeas.recover_warm(JCFG, uu, xx,
                                       jfeas.WarmStart(u=w_u, lam=w_l))
        return cold, warm, new

    out = jax.jit(jax.vmap(both))(*map(jnp.asarray, (u, x, wu, wl)))
    return jax.tree.map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _replay(x0, u_nn, u, lam):
    """The port's ``_run`` written out, scenario-batched as there, with the
    smallest relative gap of each scenario's decisions and the largest GN
    step taken at a decision closer than ``TIE``."""
    gap = torch.full_like(u, np.inf)
    tie_step = torch.zeros_like(u)

    def note(g, step):
        nonlocal gap, tie_step
        gap = torch.minimum(gap, g)
        tie_step = torch.where(g < TIE, torch.maximum(tie_step, step.abs()),
                               tie_step)

    alphas = torch.tensor(feas.ALPHAS, dtype=u.dtype)
    n = len(feas.ALPHAS)
    x0_c, u_nn_c = feas._expand(x0, n), feas._expand(u_nn, n)
    mu = float(CFG.mu0)
    for _ in range(CFG.al_iters):
        lam_c = feas._expand(lam, n)
        for _ in range(CFG.iters):
            r, _ = feas._al_residual(CFG, x0, u_nn,
                                     ad.Dual(u, torch.ones_like(u)[:, None]),
                                     lam, mu)
            J, r = r.t[..., 0], r.p
            du = -torch.sum(J * r, -1) / (torch.sum(J * J, -1) + 1e-8)
            u_c = u[:, None] + alphas * du[:, None]
            r_try, _ = feas._al_residual(CFG, x0_c, u_nn_c, u_c, lam_c, mu)
            costs = 0.5 * torch.sum(r_try * r_try, -1)
            cost0 = 0.5 * torch.sum(r * r, -1)
            srt = torch.sort(costs, dim=1).values
            note((srt[:, 1] - srt[:, 0]) / cost0, du)
            u_best, cost = feas._pick(u_c, costs)
            note((cost - cost0).abs() / cost0, du)
            u = torch.where(cost < cost0, u_best, u)
        _, c = feas._al_residual(CFG, x0, u_nn, u, lam, mu)
        lam = torch.clamp_min(lam - mu * c, 0.0)
        mu *= CFG.mu_factor
    return u, lam, gap, tie_step


def _seed_gap(x0, u_nn):
    n = len(feas.SEED_OFFSETS)
    seeds = u_nn[:, None] + torch.tensor(feas.SEED_OFFSETS,
                                         dtype=u_nn.dtype)
    r, _ = feas._al_residual(CFG, feas._expand(x0, n), feas._expand(u_nn, n),
                             seeds, torch.zeros(len(u_nn), n, 8), CFG.mu0)
    costs = torch.sort(0.5 * torch.sum(r ** 2, -1), dim=1).values
    return seeds, (costs[:, 1] - costs[:, 0]) / costs[:, 0]


def _check_u(got, want, ties, tie_step, what):
    """The states a near tie decided differently (met a tie, and their
    commands differ visibly, by more than 1e-13) are reported; they must
    agree within the largest tied step, and be few.  Every other state is
    held to the full tolerance here and by the caller.  Returns the mask
    of the reported states."""
    diff = np.abs(got - want)
    reported = ties & (diff > 1e-13)
    held = ~reported
    np.testing.assert_allclose(got[held], want[held], rtol=1e-9, atol=1e-12,
                               err_msg=what)
    assert np.all(diff[reported] <= 1e-12 + tie_step[reported]), what
    assert reported.sum() <= N_STATES // 2, (what, np.flatnonzero(reported))
    print(f"{what}: states a near tie decided differently (reported, not "
          f"held to the tolerance): {np.flatnonzero(reported).tolist()}, "
          f"|du| {diff[reported].tolist()}; largest |du| of the others "
          f"{diff[held].max():.3e}")
    return reported


def test_torch_recover_matches_jax():
    x, u, _, _ = _states()
    cold, _, _ = _jax_results()
    res = feas.recover(CFG, _t(u), _t(x))
    seeds, seed_gap = _seed_gap(_t(x), _t(u))
    # The seed the port picked, then its decisions along the way.
    r_s, _ = feas._al_residual(CFG, feas._expand(_t(x), 7),
                               feas._expand(_t(u), 7), seeds,
                               torch.zeros(N_STATES, 7, 8), CFG.mu0)
    u_init, _ = feas._pick(seeds, 0.5 * torch.sum(r_s ** 2, -1))
    u_rep, _, gap, tie_step = _replay(_t(x), _t(u), u_init,
                                      torch.zeros(N_STATES, 8))
    assert torch.equal(u_rep, res.u)           # the replay is the port's run
    ties = ((gap < TIE) | (seed_gap < TIE)).numpy()
    reported = _check_u(res.u.numpy(), cold.u, ties, tie_step.numpy(), "recover")
    ok = ~reported
    np.testing.assert_allclose(res.violation.numpy()[ok], cold.violation[ok],
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(res.changed.numpy()[ok], cold.changed[ok],
                               rtol=1e-7, atol=1e-12)
    # The set is not trivial: the projection moved about half the states.
    assert (cold.changed > 1e-3).sum() >= N_STATES // 4
    assert (cold.violation < 1e-6).sum() >= N_STATES // 4


def test_torch_recover_warm_matches_jax():
    x, u, wu, wl = _states()
    _, warm_res, warm_new = _jax_results()
    res, new = feas.recover_warm(CFG, _t(u), _t(x),
                                 feas.WarmStart(_t(wu), _t(wl)))
    u_rep, lam_rep, gap, tie_step = _replay(_t(x), _t(u), _t(wu), _t(wl))
    failed = res.violation.numpy() > 1e-2
    assert torch.equal(torch.where(torch.from_numpy(failed), _t(wu), u_rep),
                       res.u)
    # A decision at the failure threshold is a tie too.
    ties = (gap < TIE).numpy() | (np.abs(res.violation.numpy() - 1e-2) < 1e-9)
    reported = _check_u(res.u.numpy(), warm_res.u, ties, tie_step.numpy(),
                   "recover_warm")
    ok = ~reported
    assert 0 < failed.sum() < N_STATES            # both branches taken
    np.testing.assert_array_equal(failed[ok], warm_res.violation[ok] > 1e-2)
    np.testing.assert_allclose(res.violation.numpy()[ok],
                               warm_res.violation[ok], rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(new.lam.numpy()[ok], warm_new.lam[ok],
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(new.u.numpy()[ok], warm_new.u[ok], rtol=1e-9,
                               atol=1e-12)
    assert np.all(new.u.numpy()[failed] == 0)
    assert np.all(new.lam.numpy()[failed] == 0)


def _constraints(x0, u):
    return feas._lookahead_constraints(CFG, _t(x0)[None], _t([u]))[0].numpy()


def test_torch_feasible_command_passes_through():
    """A command whose lookahead stays inside the pressure box passes
    through, cold and warm, and the warm carry holds it."""
    x0 = _t(press.X0_REFERENCE)[None]
    res = feas.recover(CFG, _t([0.03]), x0)
    assert abs(res.u.item() - 0.03) < 1e-6 and res.violation.item() < 1e-6
    res, warm = feas.recover_warm(CFG, _t([0.03]), x0,
                                  feas.init_warm(CFG, 1, torch.float64, "cpu"))
    assert abs(res.u.item() - 0.03) < 1e-6 and res.violation.item() < 1e-6
    assert abs(warm.u.item() - 0.03) < 1e-6


def test_torch_infeasible_command_projected_and_minimal():
    """From the near-cavitation state a hard negative command is pulled
    back until the lookahead keeps p1 >= 0; it is the closest such command
    (moving 70 % of the way back breaks feasibility); the policy wrapper
    does the same."""
    assert _constraints(CAVITATION, -0.2).min() < 0
    res = feas.recover(CFG, _t([-0.2]), _t(CAVITATION)[None])
    u = res.u.item()
    assert res.violation.item() < 2e-3 and res.changed.item() > 1e-3
    assert _constraints(CAVITATION, u).min() > -2e-3
    assert _constraints(CAVITATION, u + 0.7 * (-0.2 - u)).min() < -1e-3
    pol = feas.make_recovering_policy(
        lambda x, r, up: torch.full_like(r, -0.2), CFG)
    got = pol(_t(CAVITATION)[None], _t([-0.5]), _t([0.0]))
    assert -0.2 <= got.item() <= 0.2 and got.item() == u
    clipped = feas.make_recovering_policy(
        lambda x, r, up: torch.full_like(r, -0.2), CFG, lb=-0.01, ub=0.01)
    assert clipped(_t(CAVITATION)[None], _t([-0.5]),
                   _t([0.0])).item() == -0.01


def test_torch_warm_start_failure_fallback():
    """On failure the previous command is applied and the warm start reset
    (fail_tol forced below every violation), scenario by scenario."""
    x0 = _t(press.X0_REFERENCE)[None].repeat(2, 1)
    warm = feas.WarmStart(u=_t([0.123, -0.05]), lam=torch.ones(2, 8,
                                                               dtype=torch.float64))
    res, new = feas.recover_warm(CFG, _t([0.05, 0.05]), x0, warm,
                                 fail_tol=-1.0)
    assert res.u.tolist() == [0.123, -0.05]
    assert torch.all(new.lam == 0) and torch.all(new.u == 0)
    res, new = feas.recover_warm(CFG, _t([0.05, 0.05]), x0, warm)
    assert torch.all(res.violation < 1e-2) and torch.all(new.u == res.u)


def test_torch_warm_carry_closed_loop_matches_cold():
    """RecoveringController (warm carry through the episode) against the
    cold multi-start policy over a short raw closed loop across a reference
    step: both finite, most steps agree, and the warm run's commands keep
    the lookahead feasible (the assertions of the JAX package's test, on a
    shorter episode)."""
    def base(x, r, up):
        return torch.clamp(4.0 * (r - x[:, 1]), -0.25, 0.25)

    T = 8
    loop_cfg = cl.LoopConfig(t_steps=T, variant="raw")
    x0 = _t(press.X0_REFERENCE)[None]
    refs = torch.where(torch.arange(T) < T // 2, 0.35, -0.35)[None].double()
    warm_ctrl = feas.RecoveringController(base, CFG)
    _, t_warm = cl.run_batch(loop_cfg, warm_ctrl, x0, refs, device="cpu")
    cold_ctrl = cl.FunctionController(feas.make_recovering_policy(base, CFG))
    _, t_cold = cl.run_batch(loop_cfg, cold_ctrl, x0, refs, device="cpu")
    u_w, u_c = t_warm.u[0].numpy(), t_cold.u[0].numpy()
    assert np.all(np.isfinite(u_w))
    assert np.mean(np.abs(u_w - u_c) < 5e-3) > 0.7
    assert np.abs(u_w - u_c).max() < 0.5
    x_pre = torch.cat([press.measure(x0, loop_cfg.params, "raw"),
                       t_warm.x[0, :-1]])
    c = feas._lookahead_constraints(CFG, x_pre, t_warm.u[0])
    assert c.min().item() > -2e-2
    assert torch.all(t_warm.diag.iters == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_torch_recovering_controller_carry(dtype):
    """init_carry_batch: zero (B,) command and (B, 8) multipliers in the
    loop's dtype; step_batch returns the recovered command, the new carry
    and zero diagnostics of the batch."""
    ctrl = feas.RecoveringController(lambda x, r, up: 0.1 * r, CFG,
                                     lb=-0.2, ub=0.2)
    carry = ctrl.init_carry_batch(3, dtype, "cpu")
    assert carry.u.shape == (3,) and carry.lam.shape == (3, 8)
    assert carry.u.dtype == dtype and torch.all(carry.lam == 0)
    x = torch.tensor(press.X0_REFERENCE, dtype=dtype).repeat(3, 1)
    u, new, diag = ctrl.step_batch(carry, x, torch.tensor([0.3, -0.3, 5.0],
                                                          dtype=dtype), None)
    assert u.shape == (3,) and u.dtype == dtype
    assert u[2].item() == torch.tensor(0.2, dtype=dtype).item()
    assert new.lam.shape == (3, 8) and diag.obj.shape == (3,)
