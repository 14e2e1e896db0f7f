"""Batched Gauss-Newton SQP with augmented-Lagrangian constraints.

Port of ``forging_control_tpu/solver/sqp.py`` (design notes there):
condensed single shooting over the scaled input trajectory ``v`` (N =
horizon), Gauss-Newton on the stacked least-squares residuals of the do-mpc
objective, an augmented Lagrangian for the pressure bounds, a fixed
iteration structure with per-scenario convergence masking, a branch-free
step ladder, and shift warm starting.

The explicit batch is the primary form here: :func:`solve_batch` carries B
scenarios through every operation, and :func:`solve` is its B = 1 wrapper.
Two implementations, chosen by :func:`solve_batch`'s ``linsolve``:

* ``"kernel"`` — on a card, every Gauss-Newton iteration is three
  hand-written kernels: the build (:func:`~forging_control_tpu_torch.ops.
  sqp.sqp_build_cuda`: the residuals' Jacobian, ``g = J^T r``, ``H = J^T J``
  and the three damped systems), B1 on those systems
  (:func:`~forging_control_tpu_torch.ops.smallchol.chol_solve_cuda`, the
  counterpart of the JAX package's ``linsolve="pallas"``) and the line
  search (:func:`~forging_control_tpu_torch.ops.sqp.sqp_search_cuda`, which
  also updates the multipliers and writes the diagnostics), so no rollout
  is dispatched as tensor code; on the CPU the tensor code below, with
  :func:`~forging_control_tpu_torch.ops.smallchol.chol_solve` taking its
  plain version;
* ``"plain"`` — the tensor code on any device, the kernels' reference: each
  Gauss-Newton iteration takes the residual Jacobian by forward mode over
  the N input directions (:func:`~forging_control_tpu_torch.dual.linearize`,
  the counterpart of ``jax.linearize`` + ``vmap(jvp)``), forms ``g = J^T r``
  and ``H = J^T J`` with ``torch.einsum``, and solves the (B, 3, N, N) damped
  normal systems with the plain PyTorch solve (JAX's ``"unrolled"``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import dual as ad
from ..device import resolve_device
from ..integrate.rk4 import rk4_step
from ..ops import build
from ..ops import sqp as sqp_ops
from ..ops.smallchol import chol_solve, chol_solve_cuda, chol_solve_torch
from ..physics import press
from ..physics.scaling import U_SCALE

_P_SCALE = 1e7  # pressure scaling inside the NLP (template_mpc.py:34-35)

LINSOLVES = ("kernel", "plain")


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    """Static solver configuration; the same fields and defaults as the JAX
    package's ``MPCConfig``, so configurations carry across
    (:func:`forging_control_tpu_torch.interop.mpc_config_from_dict`)."""

    horizon: int = 10
    dt: float = 1e-3                 # t_step (template_mpc.py:23)
    substeps: int = 4                # RK4 substeps of the prediction model
    variant: press.Variant = "smooth"
    rterm: float = 0.02              # set_rterm(u=0.02) on scaled du
    p_min: float = 0.0               # lower pressure bound [Pa]
    p_max: float | None = None       # upper bound 32e6 when do_feasibility
    params: press.PressParams = press.DEFAULT_PARAMS

    gn_iters: int = 5                # inner Gauss-Newton iterations per AL round
    al_iters: int = 2                # augmented-Lagrangian rounds
    mu0: float = 1e2                 # initial AL penalty
    mu_factor: float = 10.0
    tol_grad: float = 1e-7           # dual-infeasibility stop (scaled units)
    lm_reg: float = 1e-8             # base Levenberg damping
    step_ladder: tuple = (1.0, 0.25)
    # Per-iteration trace (TRACE_COLS) in Diagnostics.trace.
    record_trace: bool = False
    # Active-set polish after AL convergence (see :func:`polish`).
    polish_iters: int = 0
    polish_act_tol: float = 1e-3     # |c| threshold for the active estimate
    polish_reg: float = 1e-9
    # Scheduling knobs of the JAX package's lax.scan loops.  Kept so that
    # configurations carry across; they have no effect in eager PyTorch,
    # where every loop is a Python loop.
    scan_unroll: int | bool | None = None
    iter_unroll: bool = False

    @property
    def n_con(self) -> int:
        per_stage = 2 if self.p_max is None else 4
        return per_stage * self.horizon

    @classmethod
    def fast(cls, **kw):
        """Throughput preset family for warm-started closed-loop use (fewer
        fixed iterations, short step ladder).  The qualified configuration
        is ``fast(gn_iters=5)`` ("fast_5x1"; docs/RESULTS-parity.json
        ``fast_preset_ab``).  Do not raise ``al_iters`` on this preset
        (mu0=1e4 escalates to 1e5, which destabilises tracking)."""
        defaults = dict(gn_iters=4, al_iters=1, mu0=1e4,
                        step_ladder=(1.0, 0.25))
        defaults.update(kw)
        return cls(**defaults)

    @classmethod
    def ipopt_compat(cls, **kw):
        """Preset reproducing the recorded IPOPT closed loop: p_min relaxed
        by the recording's observed violation and a soft constant AL
        penalty."""
        defaults = dict(p_min=-5e6, mu0=1.0, mu_factor=1.0)
        defaults.update(kw)
        return cls(**defaults)


class SolverState(NamedTuple):
    """Warm-start carry across closed-loop steps (cf. IPOPT warm start)."""

    v: torch.Tensor     # (..., N) scaled input trajectory
    lam: torch.Tensor   # (..., n_con) AL multipliers


TRACE_COLS = ("obj", "inf_pr", "inf_du", "d_norm", "alpha", "mu")


class Diagnostics(NamedTuple):
    """Per-solve stats mirroring the IPOPT record the reference stores
    (``Generate Data/Functions.py:366-372``).  ``trace`` is the
    per-iteration history, shape (..., al_iters * gn_iters,
    len(TRACE_COLS)), when the config sets ``record_trace``, else None."""

    iters: torch.Tensor
    obj: torch.Tensor
    inf_pr: torch.Tensor
    inf_du: torch.Tensor
    reg: torch.Tensor
    d_norm: torch.Tensor
    mu: torch.Tensor
    alpha: torch.Tensor   # last accepted step size (IPOPT alpha_pr analogue)
    trace: torch.Tensor | None = None

    @classmethod
    def zeros(cls, dtype, shape=(), device="cuda"):
        device = resolve_device(device)
        z = torch.zeros(shape, dtype=dtype, device=device)
        return cls(iters=torch.zeros(shape, dtype=torch.int32, device=device),
                   obj=z, inf_pr=z, inf_du=z, reg=z, d_norm=z, mu=z, alpha=z)


def init_state(cfg: MPCConfig, dtype=torch.float32,
               device="cuda") -> SolverState:
    device = resolve_device(device)
    return SolverState(
        v=torch.zeros(cfg.horizon, dtype=dtype, device=device),
        lam=torch.zeros(cfg.n_con, dtype=dtype, device=device))


def shift_state(state: SolverState) -> SolverState:
    """Shift the previous solution one control period (warm start); works
    on batched states (leading axes) too."""
    v = torch.cat([state.v[..., 1:], state.v[..., -1:]], dim=-1)
    return SolverState(v=v, lam=state.lam)


def _rollout(cfg: MPCConfig, x0, v):
    """States x_1..x_N (physical units), shape (..., N, 5), for scaled
    inputs v (..., N) from x0 (..., 5)."""

    def f(x, u):
        return press.rhs(x, u, cfg.params, cfg.variant)

    xs, x = [], x0
    for k in range(v.shape[-1]):
        x = rk4_step(f, x, v[..., k] * U_SCALE, cfg.dt, cfg.substeps)
        xs.append(x)
    return ad.stack(xs, dim=-2)


def _constraints(cfg: MPCConfig, xs):
    """Inequalities c(v) >= 0 in scaled pressure units, stages 1..N,
    type-major: [p1 (N), p2 (N)(, hi - p1 (N), hi - p2 (N))]."""
    p1 = xs[..., 2] / _P_SCALE
    p2 = xs[..., 3] / _P_SCALE
    lo = cfg.p_min / _P_SCALE
    cons = [p1 - lo, p2 - lo]
    if cfg.p_max is not None:
        hi = cfg.p_max / _P_SCALE
        cons += [hi - p1, hi - p2]
    return ad.cat(cons, dim=-1)


def _du(u_prev_s, v):
    """Scaled input increments, u_prev_s (...,) then v (..., N)."""
    uv = ad.cat([u_prev_s[..., None], v], dim=-1)
    return uv[..., 1:] - uv[..., :-1]


def _residuals(cfg: MPCConfig, x0, ref, u_prev_s, lam, mu, v):
    """Stacked least-squares residuals of the AL-regularised objective.

    Layout: [tracking (N), sqrt(rterm)*du (N), sqrt(mu/2)*active-constraint
    (n_con)]; also returns the raw constraint values.
    """
    xs = _rollout(cfg, x0, v)
    r_track = xs[..., 1] - ref[..., None]
    r_du = math.sqrt(cfg.rterm) * _du(u_prev_s, v)
    c = _constraints(cfg, xs)
    # AL term: (mu/2) * max(0, lam/mu - c)^2  (classic Rockafellar form)
    r_con = torch.sqrt(mu / 2.0) * ad.maximum(lam / mu - c, 0.0)
    return ad.cat([r_track, r_du, r_con], dim=-1), c


def _obj_res_con(cfg: MPCConfig, x0, ref, u_prev_s, v):
    """Objective-only least-squares residuals + raw constraint values."""
    xs = _rollout(cfg, x0, v)
    r_track = xs[..., 1] - ref[..., None]
    r = ad.cat([r_track, math.sqrt(cfg.rterm) * _du(u_prev_s, v)], dim=-1)
    return r, _constraints(cfg, xs)


def _infeasibility(c):
    return torch.clamp_min(torch.amax(-c, dim=-1), 0.0)


def _objective(cfg: MPCConfig, x0, ref, u_prev_s, v):
    """The true (non-AL) objective and the primal infeasibility at v, from
    a rollout: solve_batch's final diagnostics."""
    xs = _rollout(cfg, x0, v)
    r_track = xs[..., 1] - ref[:, None]
    dv = _du(u_prev_s, v)
    obj = torch.sum(r_track ** 2, dim=-1) + cfg.rterm * torch.sum(dv ** 2,
                                                                  dim=-1)
    return obj, _infeasibility(_constraints(cfg, xs))


def polish(cfg: MPCConfig, x0, ref, u_prev_s, v, lam):
    """Active-set Newton polish of an AL-converged iterate, batched over the
    leading axis (see the JAX package's ``sqp.polish``).

    Solves the equality-constrained Gauss-Newton QP of the estimated active
    set via a masked Schur complement, re-estimating the set each
    iteration, and keeps the polished point only where it does not worsen
    the exact-penalty merit.  The Schur systems reach n_con = 4N rows, and
    they go to the plain solve, as the JAX package sends them to its jnp
    solve rather than the kernel.
    """
    dtype, device = v.dtype, v.device
    B, N = v.shape
    n_obj = 2 * N
    eye = torch.eye(N, dtype=dtype, device=device)

    def lin(vv):
        out, J = ad.linearize(
            lambda w: ad.cat(_obj_res_con(cfg, x0, ref, u_prev_s, w), -1), vv)
        Jt = J.transpose(-1, -2)                   # (B, N, n_obj + n_con)
        return out[:, :n_obj], out[:, n_obj:], Jt[..., :n_obj], Jt[..., n_obj:]

    r0, c0 = _obj_res_con(cfg, x0, ref, u_prev_s, v)
    obj0 = torch.sum(r0 * r0, dim=-1)
    infeas0 = _infeasibility(c0)

    # Initial active estimate from the AL multipliers.
    m = ((c0 < cfg.polish_act_tol) | (lam > 0)).to(dtype)
    v_p = v
    for _ in range(cfg.polish_iters):
        r, c, Jr, Jc = lin(v_p)                    # Jc: (B, N, n_con)
        g = torch.einsum("bno,bo->bn", Jr, r)
        H = torch.einsum("bno,bmo->bnm", Jr, Jr) + cfg.polish_reg * eye
        nc = c.shape[-1]
        JcT = Jc.transpose(1, 2)                   # (B, nc, N)
        rhs = torch.cat([JcT, g[:, None, :]], dim=1)          # (B, nc+1, N)
        sol = chol_solve_torch(H[:, None].expand(B, nc + 1, N, N), rhs)
        HiJc, Hig = sol[:, :nc].transpose(1, 2), sol[:, nc]
        S = m[:, :, None] * m[:, None, :] * (JcT @ HiJc) \
            + torch.diag_embed(1.0 - m) \
            + 1e-10 * torch.eye(nc, dtype=dtype, device=device)
        nu = chol_solve_torch(S, m * (torch.einsum("bcn,bn->bc", JcT, Hig)
                                      - c))
        dv = torch.einsum("bnc,bc->bn", HiJc, m * nu) - Hig
        v_p = v_p + dv
        # Re-estimate: drop nu <= 0, add (newly) violated constraints.
        c_lin = c + torch.einsum("bn,bnc->bc", dv, Jc)
        m = (((m > 0) & (nu > 0))
             | (c_lin < -cfg.polish_act_tol)).to(dtype)

    r1, c1 = _obj_res_con(cfg, x0, ref, u_prev_s, v_p)
    obj1 = torch.sum(r1 * r1, dim=-1)
    infeas1 = _infeasibility(c1)
    # Exact-penalty merit with a float-eps-scale tolerance: an already
    # optimal AL iterate must not drift.
    w = 1e3
    merit0 = obj0 + w * infeas0
    merit1 = obj1 + w * infeas1
    tol = 64 * torch.finfo(dtype).eps * (1.0 + merit0)
    ok = torch.isfinite(merit1) & (merit1 <= merit0 + tol)
    return torch.where(ok[:, None], v_p, v)


def _gauss_newton(cfg: MPCConfig, x0, ref, u_prev_s, lam, mu, v):
    """Residual r, gradient g = J^T r and normal matrix H = J^T J at v."""
    r, J = ad.linearize(
        lambda vv: _residuals(cfg, x0, ref, u_prev_s, lam, mu, vv)[0], v)
    g = torch.einsum("bri,br->bi", J, r)
    H = torch.einsum("bri,brj->bij", J, J)
    return r, g, H


def _damping(cfg: MPCConfig, dtype, device):
    """The three Levenberg dampings, made once per solve by fill ops."""
    return ad.constants([cfg.lm_reg, cfg.lm_reg + 1e-2, cfg.lm_reg + 1.0],
                        dtype, device)


def _damped(H, g, regs):
    """The three damped copies of the normal system: H (B, N, N), g (B, N)
    -> (B, 3, N, N), (B, 3, N)."""
    B, N = g.shape
    eye = torch.eye(N, dtype=g.dtype, device=g.device)
    return H[:, None] + regs[None, :, None, None] * eye, \
        g[:, None, :].expand(B, 3, N)


def _prepare(x0, ref, u_prev, state: SolverState):
    dtype, device = state.v.dtype, state.v.device
    B = state.v.shape[0]
    x0 = torch.as_tensor(x0, device=device).to(dtype)
    ref = torch.as_tensor(ref, device=device).to(dtype).expand(B)
    u_prev_s = torch.as_tensor(u_prev, device=device).to(dtype).expand(B) \
        / U_SCALE
    return x0, ref, u_prev_s


def damped_systems(cfg: MPCConfig, x0, ref, u_prev, state: SolverState):
    """The (B, 3, N, N) damped normal matrices and (B, 3, N) right-hand
    sides that :func:`solve_batch`'s first Gauss-Newton iteration hands to
    its linear solve (the solve returns minus the steps)."""
    x0, ref, u_prev_s = _prepare(x0, ref, u_prev, state)
    dtype, device = state.v.dtype, state.v.device
    mu = torch.full((), cfg.mu0, dtype=dtype, device=device)
    _, g, H = _gauss_newton(cfg, x0, ref, u_prev_s, state.lam, mu, state.v)
    return _damped(H, g, _damping(cfg, dtype, device))


def solve_batch(cfg: MPCConfig, x0, ref, u_prev, state: SolverState, *,
                linsolve: str = "kernel"):
    """B scenarios of one MPC solve (the `make_step` equivalent).

    Args:
      x0: (B, 5) measured states, physical units.
      ref: (B,) speed references, held over the horizon.
      u_prev: (B,) previously applied inputs (physical).
      state: batched warm start (``v`` (B, N), ``lam`` (B, n_con)), already
        shifted.  Its dtype and device set those of the solve.
      linsolve: ``"kernel"`` or ``"plain"`` (see the module docstring).

    Dispatch: a state on a card with ``linsolve="kernel"`` runs the
    kernels (build, B1 and search a Gauss-Newton iteration; the polish, if
    the configuration asks for it, after them in tensor code), and raises
    where they cannot run (N above B1's 25): there is no fallback.
    ``"plain"`` on any device, and every solve on the CPU, runs the tensor
    code.  Any other device or ``linsolve`` raises.

    Returns (u0 (B,), SolverState, Diagnostics with (B,) leaves).
    """
    if linsolve == "kernel":
        lin = chol_solve
    elif linsolve == "plain":
        lin = chol_solve_torch
    else:
        raise ValueError(f"unknown linsolve {linsolve!r}; one of {LINSOLVES}")
    if build.on_card(state.v.device) and linsolve == "kernel":
        return _solve_batch_kernel(cfg, x0, ref, u_prev, state)
    dtype, device = state.v.dtype, state.v.device
    B, N = state.v.shape
    x0, ref, u_prev_s = _prepare(x0, ref, u_prev, state)
    nc = cfg.n_con

    n_lad = len(cfg.step_ladder)
    n_cand = n_lad + 2
    alphas = ad.constants(list(cfg.step_ladder) + [1.0, 1.0], dtype, device)
    regs = _damping(cfg, dtype, device)
    bidx = torch.arange(B, device=device)
    # Candidate axis: the same scenario data for every step candidate.
    x0_c = x0[:, None].expand(B, n_cand, 5)
    ref_c = ref[:, None].expand(B, n_cand)
    up_c = u_prev_s[:, None].expand(B, n_cand)

    v, lam = state.v, state.lam
    mu = torch.full((), cfg.mu0, dtype=dtype, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    d_norm = torch.zeros(B, dtype=dtype, device=device)
    inf_du = torch.zeros(B, dtype=dtype, device=device)
    alpha = torch.zeros(B, dtype=dtype, device=device)
    traces = []

    for _ in range(cfg.al_iters):
        for _ in range(cfg.gn_iters):
            r, g, H = _gauss_newton(cfg, x0, ref, u_prev_s, lam, mu, v)
            cost0 = 0.5 * torch.sum(r * r, dim=-1)
            gnorm = torch.amax(torch.abs(g), dim=-1)
            converged = gnorm < cfg.tol_grad

            dvs = -lin(*_damped(H, g, regs))

            dirs = torch.cat([dvs[:, :1].expand(B, n_lad, N), dvs[:, 1:]],
                             dim=1)
            vs = v[:, None, :] + alphas[None, :, None] * dirs
            r_try, _ = _residuals(cfg, x0_c, ref_c, up_c,
                                  lam[:, None].expand(B, n_cand, nc), mu, vs)
            costs = 0.5 * torch.sum(r_try * r_try, dim=-1)     # (B, C)
            dns = torch.linalg.vector_norm(alphas[None, :, None] * dirs,
                                           dim=-1)
            best = torch.argmin(costs, dim=1)
            take = (costs[bidx, best] < cost0) & ~converged

            v_in = v
            v = torch.where(take[:, None], vs[bidx, best], v)
            d_norm = torch.where(take, dns[bidx, best], 0.0)
            alpha = torch.where(take, alphas[best], alpha)
            iters = iters + (~converged).to(torch.int32)
            inf_du = gnorm
            if cfg.record_trace:
                # Record at the incoming iterate (TRACE_COLS layout); the raw
                # constraint values need one extra rollout, paid only here.
                c = _constraints(cfg, _rollout(cfg, x0, v_in))
                r_obj = r[:, :2 * N]
                traces.append(torch.stack(
                    [torch.sum(r_obj * r_obj, dim=-1), _infeasibility(c),
                     gnorm, d_norm, alpha, mu.expand(B)], dim=-1))
        c = _constraints(cfg, _rollout(cfg, x0, v))
        lam = torch.clamp_min(lam - mu * c, 0.0)
        mu = mu * cfg.mu_factor

    if cfg.polish_iters > 0:
        v = polish(cfg, x0, ref, u_prev_s, v, lam)

    obj, inf_pr = _objective(cfg, x0, ref, u_prev_s, v)
    diag = Diagnostics(
        iters=iters,
        obj=obj,
        inf_pr=inf_pr,
        inf_du=inf_du,
        reg=torch.full((B,), cfg.lm_reg, dtype=dtype, device=device),
        d_norm=d_norm,
        mu=mu.expand(B).clone(),
        alpha=alpha,
        trace=torch.stack(traces, dim=1) if cfg.record_trace else None,
    )
    return v[:, 0] * U_SCALE, SolverState(v=v, lam=lam), diag


def kernel_cfg(cfg: MPCConfig, N: int):
    """The kernels' configuration (``ops.sqp.SqpCfgC``) for ``cfg`` at
    horizon N, with this solver's pressure scale."""
    return sqp_ops.sqp_cfg_c(cfg, N, _P_SCALE)


def _solve_batch_kernel(cfg: MPCConfig, x0, ref, u_prev,
                        state: SolverState):
    """:func:`solve_batch` through the kernels: per Gauss-Newton iteration
    the build, B1 on the (B, 3, N, N) damped systems and the search
    (``ops.sqp.schedule``); with ``polish_iters`` the polish, the rollout
    and the final diagnostics follow in tensor code."""
    v, lam = state.v.contiguous(), state.lam.contiguous()
    B, N = v.shape
    dtype, device = v.dtype, v.device
    x0 = torch.as_tensor(x0, device=device).to(dtype).contiguous()
    ref = torch.as_tensor(ref, device=device).to(dtype).expand(B).contiguous()
    u_prev = torch.as_tensor(u_prev, device=device).to(dtype).expand(B) \
        .contiguous()
    kcfg = kernel_cfg(cfg, N)
    bufs = sqp_ops.allocate(kcfg, v)
    out = bufs.out
    for step in sqp_ops.schedule(cfg.al_iters, cfg.gn_iters,
                                 cfg.record_trace):
        sqp_ops.sqp_build_cuda(kcfg, cfg.params, x0, ref, u_prev, v, lam,
                               bufs, step)
        x = bufs.g
        if step.flags & sqp_ops.STEP:
            x = chol_solve_cuda(bufs.H.view(3 * B, N, N),
                                bufs.g.view(3 * B, N)).view(B, 3, N)
        sqp_ops.sqp_search_cuda(kcfg, cfg.params, x0, ref, u_prev, v, lam, x,
                                bufs, step)
        v = out.v
        if step.flags & sqp_ops.ROUND_END:
            lam = out.lam
    diag = Diagnostics(iters=out.iters, obj=out.obj, inf_pr=out.inf_pr,
                       inf_du=out.inf_du, reg=out.reg, d_norm=out.d_norm,
                       mu=out.mu, alpha=out.alpha, trace=out.trace)
    if cfg.polish_iters <= 0:
        return out.u0, SolverState(v=v, lam=lam), diag
    u_prev_s = u_prev / U_SCALE
    v = polish(cfg, x0, ref, u_prev_s, v, lam)
    obj, inf_pr = _objective(cfg, x0, ref, u_prev_s, v)
    return v[:, 0] * U_SCALE, SolverState(v=v, lam=lam), \
        diag._replace(obj=obj, inf_pr=inf_pr)


def solve(cfg: MPCConfig, x0, ref, u_prev, state: SolverState, *,
          linsolve: str = "kernel"):
    """One MPC solve: the B = 1 wrapper of :func:`solve_batch`.

    ``x0`` (5,), scalar ``ref``/``u_prev``, unbatched ``state``.  Returns
    (u0, SolverState, Diagnostics) without the batch axis.
    """
    dtype, device = state.v.dtype, state.v.device
    u0, st, diag = solve_batch(
        cfg, torch.as_tensor(x0, device=device).to(dtype)[None],
        torch.as_tensor(ref, dtype=dtype, device=device).reshape(1),
        torch.as_tensor(u_prev, dtype=dtype, device=device).reshape(1),
        SolverState(v=state.v[None], lam=state.lam[None]), linsolve=linsolve)
    sq = lambda a: None if a is None else a[0]  # noqa: E731
    return sq(u0), SolverState(v=st.v[0], lam=st.lam[0]), \
        Diagnostics(*(sq(a) for a in diag))
