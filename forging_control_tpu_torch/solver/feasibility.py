"""Feasibility recovery — safety projection of NN commands, batched.

Port of ``forging_control_tpu/solver/feasibility.py`` (the reference's
feasibility-recovery NLP, ``Supervised Learning/Main.py:519-605`` and
``FeasibilityRecovery.feasibility_recover``, ``Supervised Learning/
Functions.py:933-1011``): project the NN command ``u_NN`` onto the commands
whose 2-step RK4 lookahead (raw model, 1 ms steps, 4 substeps) keeps both
chamber pressures inside [0, 32e6] Pa,

    min_u  (1/0.2) * (u_NN - u)^2   s.t.  p1, p2 in [0, PS] at both steps,

by an augmented-Lagrangian Gauss-Newton iteration on the scalar command
(the "linear solve" is a division).

Every function carries B scenarios explicitly: each scenario's command is
an entry of a (B,) tensor, the 7 multi-start seeds are one (B, 7)
evaluation, the 3 backtracking candidates one (B, 3) evaluation, and the
Jacobian of the residual in u is one dual tangent (``dual.py``, whose
``maximum`` splits its tangent at a tie as JAX's does).  Scenario by
scenario this is the JAX package's arithmetic; the seed and candidate
axes cut the count of eager ops by those factors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from .. import dual as ad
from ..device import resolve_device
from ..integrate.rk4 import rk4_step
from ..physics import press
from . import sqp

_U_SCALE = 0.2     # scaling_factors['u'] = 1/0.2 (Main.py:542)
_P_SCALE = 32e6    # scaling_factors['p1'] = 1/32e6
SEED_OFFSETS = (0.0, 0.1, -0.1, 0.2, -0.2, 0.3, 0.4)
ALPHAS = (1.0, 0.5, 0.1)       # the backtracking ladder of a GN step


@dataclasses.dataclass(frozen=True)
class FeasibilityConfig:
    """The same fields and defaults as the JAX package's."""

    dt: float = 1e-3
    substeps: int = 4
    lookahead: int = 2            # F applied twice (Main.py:575-576)
    p_lo: float = 0.0
    p_hi: float = 32e6
    params: press.PressParams = press.DEFAULT_PARAMS
    variant: press.Variant = "raw"   # forging_model is the raw ODE
    iters: int = 10
    al_iters: int = 3
    mu0: float = 1e2
    mu_factor: float = 10.0


class FeasibilityResult(NamedTuple):
    u: torch.Tensor          # (B,) recovered command
    violation: torch.Tensor  # (B,) max scaled constraint violation at u
    changed: torch.Tensor    # (B,) |u - u_NN|


class WarmStart(NamedTuple):
    """Cross-step warm start, the reference's ``warm_start`` dict
    (``Supervised Learning/Functions.py:957-1011``): the previous recovered
    command and the constraint multipliers, per scenario."""

    u: torch.Tensor    # (B,)
    lam: torch.Tensor  # (B, 4 * lookahead) AL multipliers (reference: lam_g)


def init_warm(cfg: FeasibilityConfig, n_batch: int, dtype=torch.float32,
              device="cuda") -> WarmStart:
    """Zero warm start (Supervised Learning/Main.py:607-608)."""
    device = resolve_device(device)
    return WarmStart(
        u=torch.zeros(n_batch, dtype=dtype, device=device),
        lam=torch.zeros(n_batch, 4 * cfg.lookahead, dtype=dtype,
                        device=device))


def _lookahead_constraints(cfg: FeasibilityConfig, x0, u):
    """Scaled bounds of p1, p2 after each lookahead step, c >= 0 when
    feasible: (..., 4 * lookahead) for x0 (..., 5) and u (...) (a tensor
    or a dual)."""
    def f(x, uu):
        return press.rhs(x, uu, cfg.params, cfg.variant)

    cons = []
    x = x0
    for _ in range(cfg.lookahead):
        x = rk4_step(f, x, u, cfg.dt, cfg.substeps)
        for i in (2, 3):
            cons.append((x[..., i] - cfg.p_lo) / _P_SCALE)
            cons.append((cfg.p_hi - x[..., i]) / _P_SCALE)
    return ad.stack(cons, dim=-1)


def _al_residual(cfg, x0, u_nn, u, lam, mu: float):
    """AL least-squares residual [objective, constraints] (..., 1 + n_con)
    and the raw constraints."""
    c = _lookahead_constraints(cfg, x0, u)
    r_obj = math.sqrt(1.0 / _U_SCALE) * (u - u_nn)
    r_con = math.sqrt(mu / 2.0) * ad.maximum(lam / mu - c, 0.0)
    return ad.cat([r_obj[..., None], r_con], dim=-1), c


def _expand(a, k):
    """(B, ...) -> (B, k, ...) along a new candidate axis."""
    return a[:, None].expand(a.shape[0], k, *a.shape[1:])


def _pick(values, costs):
    """values[b, argmin_k costs[b, k]] (the first minimum, as jnp.argmin)."""
    best = torch.argmin(costs, dim=1, keepdim=True)
    return values.gather(1, best)[:, 0], costs.gather(1, best)[:, 0]


def _run(cfg: FeasibilityConfig, x0, u_nn, u, lam):
    """``al_iters`` AL rounds of ``iters`` GN steps from (u, lam); returns
    the final (u, lam)."""
    n = len(ALPHAS)
    alphas = ad.constants(ALPHAS, u.dtype, u.device)
    x0_c, u_nn_c = _expand(x0, n), _expand(u_nn, n)
    mu = float(cfg.mu0)
    for _ in range(cfg.al_iters):
        lam_c = _expand(lam, n)
        for _ in range(cfg.iters):
            r, _ = _al_residual(cfg, x0, u_nn,
                                ad.Dual(u, torch.ones_like(u)[:, None]),
                                lam, mu)
            J = r.t[..., 0]
            r = r.p
            du = -torch.sum(J * r, dim=-1) / (torch.sum(J * J, dim=-1) + 1e-8)
            u_c = u[:, None] + alphas * du[:, None]            # (B, 3)
            r_try, _ = _al_residual(cfg, x0_c, u_nn_c, u_c, lam_c, mu)
            u_best, cost = _pick(u_c, 0.5 * torch.sum(r_try * r_try, -1))
            u = torch.where(cost < 0.5 * torch.sum(r * r, dim=-1), u_best, u)
        _, c = _al_residual(cfg, x0, u_nn, u, lam, mu)
        lam = torch.clamp_min(lam - mu * c, 0.0)
        mu *= cfg.mu_factor
    return u, lam


def _violation(cfg, x0, u):
    c = _lookahead_constraints(cfg, x0, u)
    return torch.clamp_min(torch.amax(-c, dim=-1), 0.0)


def recover(cfg: FeasibilityConfig, u_nn, x0) -> FeasibilityResult:
    """Project the commands u_nn (B,) of states x0 (B, 5) onto the feasible
    set.

    Multi-start: the valve-flow sign flip at z = 0 makes the 2-step pressure
    landscape nonconvex in u, so each scenario starts from the best of the
    seeds u_nn + ``SEED_OFFSETS`` by AL cost (the first, on a tie)."""
    x0 = x0.to(u_nn.dtype)
    n, n_con = len(SEED_OFFSETS), 4 * cfg.lookahead
    lam0 = torch.zeros(u_nn.shape[0], n_con, dtype=u_nn.dtype,
                       device=u_nn.device)
    seeds = u_nn[:, None] + ad.constants(SEED_OFFSETS, u_nn.dtype,
                                         u_nn.device)
    r_s, _ = _al_residual(cfg, _expand(x0, n), _expand(u_nn, n), seeds,
                          _expand(lam0, n), float(cfg.mu0))
    u_init, _ = _pick(seeds, 0.5 * torch.sum(r_s ** 2, dim=-1))
    u, _ = _run(cfg, x0, u_nn, u_init, lam0)
    return FeasibilityResult(u=u, violation=_violation(cfg, x0, u),
                             changed=torch.abs(u - u_nn))


def recover_warm(cfg: FeasibilityConfig, u_nn, x0, warm: WarmStart,
                 fail_tol: float = 1e-2):
    """Warm-started projection with the reference's carry and fallback
    (``Supervised Learning/Functions.py:957-1011``): start from the previous
    step's command and multipliers; where the result still violates the
    scaled constraints by more than ``fail_tol``, apply the *previous*
    command and reset that scenario's warm start to zeros.

    Returns ``(FeasibilityResult, WarmStart)``."""
    x0 = x0.to(u_nn.dtype)
    wu = warm.u.to(u_nn.dtype)
    u, lam = _run(cfg, x0, u_nn, wu, warm.lam.to(u_nn.dtype))
    violation = _violation(cfg, x0, u)
    failed = violation > fail_tol
    u_out = torch.where(failed, wu, u)
    new_warm = WarmStart(u=torch.where(failed, 0.0, u),
                         lam=torch.where(failed[:, None], 0.0, lam))
    return FeasibilityResult(u=u_out, violation=violation,
                             changed=torch.abs(u_out - u_nn)), new_warm


def _clip(u, lb, ub):
    if lb is None and ub is None:
        return u
    return torch.clamp(u, lb, ub)


@dataclasses.dataclass(frozen=True)
class RecoveringController:
    """Batched closed-loop controller wrapping a policy with *warm-started*
    feasibility recovery, the stateful composition the reference runs in
    ``NeuralNetwork.loop`` (``Supervised Learning/Functions.py:673-885``):
    the warm start is the controller's carry through the episode.

    ``base_policy(x_meas (B, 5), ref (B,), u_prev (B,)) -> u_nn (B,)``;
    lb/ub optionally apply the reference's declared (never enforced) +-0.2
    saturation."""

    base_policy: Callable
    cfg: FeasibilityConfig = FeasibilityConfig()
    lb: float | None = None
    ub: float | None = None
    fail_tol: float = 1e-2

    def init_carry_batch(self, n_batch: int, dtype, device="cuda"):
        return init_warm(self.cfg, n_batch, dtype, device)

    def step_batch(self, carry, x_meas, ref, u_prev):
        u_nn = self.base_policy(x_meas, ref, u_prev)
        res, warm = recover_warm(self.cfg, u_nn, x_meas, carry,
                                 fail_tol=self.fail_tol)
        return (_clip(res.u, self.lb, self.ub), warm,
                sqp.Diagnostics.zeros(x_meas.dtype, x_meas.shape[:1],
                                      x_meas.device))


def make_recovering_policy(base_policy, cfg: FeasibilityConfig,
                           lb=None, ub=None):
    """Wrap a batched policy with (cold, multi-start) feasibility recovery,
    the ``NN_make_step(..., feasibility_variables)`` composition (Supervised
    Learning/Functions.py:1014-1068); lb/ub apply saturation
    unconditionally."""

    def policy(x_meas, ref, u_prev):
        u_nn = base_policy(x_meas, ref, u_prev)
        return _clip(recover(cfg, u_nn, x_meas).u, lb, ub)

    return policy
