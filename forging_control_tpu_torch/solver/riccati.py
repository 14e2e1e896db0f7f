"""AL-iLQR solver backend — batched Riccati-structured MPC.

Port of ``forging_control_tpu/solver/riccati.py`` (design notes there).  The
same NLP as the condensed SQP (:mod:`.sqp`), solved with a time-structured
LQR backward sweep over 6x6 blocks: augmented state ``z = [x (5), w]`` with
``w`` the previously applied scaled input, control ``v_k``, dynamics
``z+ = [F(x, v), v]``, Gauss-Newton quadraticisation of the stage residuals,
an augmented Lagrangian for the pressure bounds, a 4-alpha forward line
search and per-scenario convergence masking.

Two implementations, chosen by :func:`solve_batch`'s ``solver``:

* ``"kernel"`` (the default) — on a card, the whole solve is one launch of
  the hand-written CUDA kernel K5 (:func:`~forging_control_tpu_torch.ops.
  ilqr.ilqr_cuda`), the counterpart of the XLA program that the JAX package
  compiles from its scans; on the CPU the plain version;
* ``"plain"`` — the tensor code below on any device, the kernel's
  reference: every stage linearised in one forward-mode sweep with 7
  tangents (:func:`~forging_control_tpu_torch.dual.linearize`), the horizon
  loops Python loops, the backward sweep a reversed one, the block algebra
  ``torch.einsum``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import dual as ad
from ..device import resolve_device
from ..integrate.rk4 import rk4_step
from ..ops import build
from ..ops import ilqr as ilqr_ops
from ..physics import press
from ..physics.scaling import U_SCALE
from .sqp import TRACE_COLS, Diagnostics, MPCConfig, _P_SCALE, polish  # noqa: F401

# Forward line-search ladder on the feedforward term.
_ALPHAS = (1.0, 0.5, 0.1, 0.02)

SOLVERS = ("kernel", "plain")


class ILQRState(NamedTuple):
    v: torch.Tensor     # (..., N) scaled input trajectory (warm start)
    lam: torch.Tensor   # (..., N, nc) AL multipliers, stage-major


def _nc(cfg: MPCConfig) -> int:
    return 2 if cfg.p_max is None else 4


def init_state(cfg: MPCConfig, dtype=torch.float32, device="cuda") -> ILQRState:
    device = resolve_device(device)
    return ILQRState(
        v=torch.zeros(cfg.horizon, dtype=dtype, device=device),
        lam=torch.zeros(cfg.horizon, _nc(cfg), dtype=dtype, device=device))


def shift_state(state: ILQRState) -> ILQRState:
    return ILQRState(
        v=torch.cat([state.v[..., 1:], state.v[..., -1:]], dim=-1),
        lam=state.lam)


def _plant_step(cfg: MPCConfig, x, v_k):
    """One control period of the prediction model; broadcasts over batch."""
    def f(xx, uu):
        return press.rhs(xx, uu, cfg.params, cfg.variant)
    return rk4_step(f, x, v_k * U_SCALE, cfg.dt, cfg.substeps)


def _aug_step(cfg: MPCConfig, z, v_k):
    """Augmented dynamics z+ = [F(x, v), v], shapes (..., 6) / (...,)."""
    x_next = _plant_step(cfg, z[..., :5], v_k)
    return ad.cat([x_next, v_k[..., None]], dim=-1)


def _constraints(cfg: MPCConfig, x):
    """Pressure inequalities c(x) >= 0 in scaled units, shape (..., nc)."""
    lo = cfg.p_min / _P_SCALE
    cons = [x[..., 2] / _P_SCALE - lo, x[..., 3] / _P_SCALE - lo]
    if cfg.p_max is not None:
        hi = cfg.p_max / _P_SCALE
        cons += [hi - x[..., 2] / _P_SCALE, hi - x[..., 3] / _P_SCALE]
    return ad.stack(cons, dim=-1)


def _al_res(cfg: MPCConfig, c, lam_k, mu):
    return torch.sqrt(mu / 2.0) * ad.maximum(lam_k / mu - c, 0.0)


def _stage_res(cfg: MPCConfig, z, v, ref, lam_k, mu):
    """Stage residual [sqrt(rterm) du, (y_dot - ref), AL constraint terms],
    broadcasting over leading axes; the k=0 mask is applied by callers."""
    c = _constraints(cfg, z[..., :5])
    du = math.sqrt(cfg.rterm) * (v - z[..., 5])
    tr = z[..., 1] - ref
    rc = _al_res(cfg, c, lam_k, mu)
    return ad.cat([du[..., None], tr[..., None], rc], dim=-1)


def _terminal_res(cfg: MPCConfig, z, ref, lam_k, mu):
    c = _constraints(cfg, z[..., :5])
    tr = z[..., 1] - ref
    return ad.cat([tr[..., None], _al_res(cfg, c, lam_k, mu)], dim=-1)


def _res_mask(cfg: MPCConfig, dtype, device):
    """Stage-0 mask: only the du residual is live (no tracking/constraint
    terms at the fixed initial state)."""
    return ad.constants([1.0] + [0.0] * (1 + _nc(cfg)), dtype, device)


def _rollout_batch(cfg: MPCConfig, x0, u_prev_s, v):
    """Departure states z_0..z_{N-1} (B, N, 6) and terminal z_N (B, 6)."""
    z = torch.cat([x0, u_prev_s[:, None]], dim=-1)
    zs = []
    for k in range(v.shape[1]):
        zs.append(z)
        z = _aug_step(cfg, z, v[:, k])
    return torch.stack(zs, dim=1), z


def _lam_dep(lam):
    """Multipliers for stage-k departure constraints: stage k >= 1 uses
    lam[k-1] (constraints at the arrival of step k-1); k=0 is masked."""
    B, N, nc = lam.shape
    return torch.cat([torch.zeros(B, 1, nc, dtype=lam.dtype,
                                  device=lam.device), lam[:, :-1]], dim=1)


def _arrivals(zs, zN):
    """Arrival states x_1..x_N (B, N, 5) from the carried trajectory."""
    return torch.cat([zs[:, 1:, :5], zN[:, None, :5]], dim=1)


def solve_batch(cfg: MPCConfig, x0, ref, u_prev, state: ILQRState, *,
                solver: str = "kernel"):
    """B scenarios of one MPC solve via AL-iLQR.

    Args:
      x0: (B, 5) measured states (physical units).
      ref: (B,) speed references (held over the horizon).
      u_prev: (B,) previously applied inputs (physical units).
      state: warm start; ``v`` (B, N), ``lam`` (B, N, nc).
      solver: "kernel" — kernel K5 when the state lies on a card, the
        plain version on the CPU; "plain" — the tensor code on any device.
        Any other device raises.

    Returns (u0 (B,), new ILQRState, Diagnostics with (B,) leaves).
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; expected one of "
                         f"{SOLVERS}")
    if build.on_card(state.v.device) and solver == "kernel":
        return _solve_batch_kernel(cfg, x0, ref, u_prev, state)
    return _solve_batch_plain(cfg, x0, ref, u_prev, state)


def _inputs(x0, ref, u_prev, B, dtype, device):
    """x0 (B, 5), ref (B,) and u_prev (B,) as tensors of the state's dtype
    on its device."""
    x0 = torch.as_tensor(x0, device=device).to(dtype)
    ref = torch.as_tensor(ref, device=device).to(dtype).expand(B)
    u_prev = torch.as_tensor(u_prev, device=device).to(dtype).expand(B)
    return x0, ref, u_prev


def kernel_cfg(cfg: MPCConfig, N: int):
    """Kernel K5's configuration (``ops.ilqr.IlqrCfgC``) for ``cfg`` at
    horizon N, with this solver's constants."""
    return ilqr_ops.ilqr_cfg_c(cfg, N, _nc(cfg), _P_SCALE, _ALPHAS)


def _solve_batch_kernel(cfg: MPCConfig, x0, ref, u_prev, state: ILQRState):
    """:func:`solve_batch` through kernel K5: one launch for the rounds and
    the diagnostics; with ``polish_iters`` the polish, the re-rollout and
    the final diagnostics follow in tensor code, as in the JAX package."""
    v, lam = state.v, state.lam
    B = v.shape[0]
    x0, ref, u_prev = _inputs(x0, ref, u_prev, B, v.dtype, v.device)
    c = lambda a: a.contiguous()  # noqa: E731
    out = ilqr_ops.ilqr_cuda(kernel_cfg(cfg, v.shape[1]), cfg.params, c(x0),
                             c(ref), c(u_prev), c(v), c(lam))
    diag = Diagnostics(iters=out.iters, obj=out.obj, inf_pr=out.inf_pr,
                       inf_du=out.inf_du, reg=out.reg, d_norm=out.d_norm,
                       mu=out.mu, alpha=out.alpha, trace=out.trace)
    if cfg.polish_iters <= 0:
        return out.u0, ILQRState(v=out.v, lam=out.lam), diag
    u_prev_s = u_prev / U_SCALE
    lam_flat = out.lam.transpose(1, 2).reshape(B, -1)
    v = polish(cfg, x0, ref, u_prev_s, out.v, lam_flat)
    zs, zN = _rollout_batch(cfg, x0, u_prev_s, v)
    obj, inf_pr = _objective(cfg, zs, zN, v, ref)
    return v[:, 0] * U_SCALE, ILQRState(v=v, lam=out.lam), \
        diag._replace(obj=obj, inf_pr=inf_pr)


def _objective(cfg: MPCConfig, zs, zN, v, ref):
    """True (non-AL) objective and primal infeasibility of the carried
    trajectory."""
    cs = _constraints(cfg, _arrivals(zs, zN))
    tr = torch.cat([zs[:, 1:, 1], zN[:, 1:2]], dim=1) - ref[:, None]
    dv = v - zs[:, :, 5]
    obj = torch.sum(tr * tr, dim=1) + cfg.rterm * torch.sum(dv * dv, dim=1)
    return obj, torch.clamp_min(torch.amax(-cs, dim=(1, 2)), 0.0)


def _solve_batch_plain(cfg: MPCConfig, x0, ref, u_prev, state: ILQRState):
    """:func:`solve_batch` in tensor code (``solver="plain"``)."""
    dtype, device = state.v.dtype, state.v.device
    B, N = state.v.shape
    x0, ref, u_prev = _inputs(x0, ref, u_prev, B, dtype, device)
    u_prev_s = u_prev / U_SCALE
    alphas = ad.constants(_ALPHAS, dtype, device)
    A_n = len(_ALPHAS)
    mask0 = _res_mask(cfg, dtype, device)
    nr = mask0.shape[0]
    bidx = torch.arange(B, device=device)
    # Residual mask per stage: stage 0 keeps only its du row.
    m = torch.ones(N, nr, dtype=dtype, device=device)
    m[0] = mask0
    ref_bn = ref[:, None].expand(B, N)

    def stage_lin(zs, v, lam_dep, mu):
        """Primal residual + full Jacobian of (dynamics, residual) of every
        stage in one 7-tangent sweep."""
        def g(zv):
            zz, vv = zv[..., :6], zv[..., 6]
            return ad.cat([_aug_step(cfg, zz, vv),
                           _stage_res(cfg, zz, vv, ref_bn, lam_dep, mu)], -1)

        out, J = ad.linearize(g, torch.cat([zs, v[..., None]], dim=-1))
        # J[..., o, i] = d out_o / d zv_i, out = [z+ (6), r (nr)].
        return (out[..., 6:], J[..., :6, :6], J[..., :6, 6], J[..., 6:, :6],
                J[..., 6:, 6])

    def term_lin(zN, lam_N, mu):
        return ad.linearize(
            lambda zz: _terminal_res(cfg, zz, ref, lam_N, mu), zN)

    def gn_iter(v, zs, zN, lam, mu, iters, alpha_l):
        ld = _lam_dep(lam)
        r, Amat, Bv, Jz, Jv = stage_lin(zs, v, ld, mu)   # (B, N, ...)
        # Stage-0 mask: zero the tracking/constraint rows (and their
        # Jacobians) at k=0.
        r = r * m
        Jz = Jz * m[None, :, :, None]
        Jv = Jv * m[None]

        rN, JzN = term_lin(zN, lam[:, -1], mu)
        cost0 = torch.sum(r * r, dim=(1, 2)) + torch.sum(rN * rN, dim=1)

        # Gauss-Newton blocks per (b, k).
        lz = 2.0 * torch.einsum("bkri,bkr->bki", Jz, r)
        lv = 2.0 * torch.einsum("bkr,bkr->bk", Jv, r)
        Lzz = 2.0 * torch.einsum("bkri,bkrj->bkij", Jz, Jz)
        Lvv = 2.0 * torch.einsum("bkr,bkr->bk", Jv, Jv)
        Lvz = 2.0 * torch.einsum("bkr,bkri->bki", Jv, Jz)
        Vz = 2.0 * torch.einsum("bri,br->bi", JzN, rN)
        Vzz = 2.0 * torch.einsum("bri,brj->bij", JzN, JzN)

        # Backward Riccati sweep over the stages, last to first.
        qmax = torch.zeros(B, dtype=dtype, device=device)
        kgs, Kgs = [None] * N, [None] * N
        for k in reversed(range(N)):
            A_k, B_k = Amat[:, k], Bv[:, k]
            Qz = lz[:, k] + torch.einsum("bji,bj->bi", A_k, Vz)
            Qv = lv[:, k] + torch.einsum("bj,bj->b", B_k, Vz)
            T = torch.einsum("bji,bjk->bik", A_k, Vzz)
            Qzz = Lzz[:, k] + torch.einsum("bik,bkl->bil", T, A_k)
            VB = torch.einsum("bjk,bk->bj", Vzz, B_k)
            Qvv = Lvv[:, k] + torch.einsum("bj,bj->b", B_k, VB) + cfg.lm_reg
            Qvz = Lvz[:, k] + torch.einsum("bj,bji->bi", VB, A_k)
            kg = -Qv / Qvv
            Kg = -Qvz / Qvv[:, None]
            Vz = Qz + Kg * Qv[:, None] + Qvz * kg[:, None] \
                + Kg * (Qvv * kg)[:, None]
            Vzz = Qzz + Kg[:, :, None] * Qvz[:, None, :] \
                + Qvz[:, :, None] * Kg[:, None, :] \
                + Qvv[:, None, None] * Kg[:, :, None] * Kg[:, None, :]
            qmax = torch.maximum(qmax, torch.abs(Qv))
            kgs[k], Kgs[k] = kg, Kg

        converged = qmax < cfg.tol_grad

        # Forward pass: all alphas in one sweep, costs accumulated in-line.
        z = torch.cat([x0, u_prev_s[:, None]], dim=-1)[None].expand(A_n, B, 6)
        cost = torch.zeros(A_n, B, dtype=dtype, device=device)
        v_cand, z_cand = [], []
        for k in range(N):
            v_new = v[None, :, k] + alphas[:, None] * kgs[k][None] \
                + torch.einsum("bi,abi->ab", Kgs[k], z - zs[None, :, k])
            r_k = _stage_res(cfg, z, v_new, ref[None], ld[None, :, k], mu)
            if k == 0:
                r_k = r_k * mask0
            cost = cost + torch.sum(r_k * r_k, dim=-1)
            v_cand.append(v_new)
            z_cand.append(z)
            z = _aug_step(cfg, z, v_new)
        rNc = _terminal_res(cfg, z, ref[None], lam[None, :, -1], mu)
        costs = cost + torch.sum(rNc * rNc, dim=-1)        # (A, B)

        best = torch.argmin(costs, dim=0)                  # (B,)
        v_best = torch.stack(v_cand, dim=-1)[best, bidx]   # (B, N)
        zs_best = torch.stack(z_cand, dim=2)[best, bidx]   # (B, N, 6)
        zN_best = z[best, bidx]                            # (B, 6)
        c_best = costs[best, bidx]

        take = (c_best < cost0) & ~converged
        tk = take[:, None]
        v_n = torch.where(tk, v_best, v)
        zs_n = torch.where(tk[:, :, None], zs_best, zs)
        zN_n = torch.where(tk, zN_best, zN)
        d_n = torch.where(take, torch.linalg.vector_norm(v_best - v, dim=-1),
                          0.0)
        a_n = torch.where(take, alphas[best], alpha_l)
        it_n = iters + (~converged).to(torch.int32)
        ys = None
        if cfg.record_trace:
            # Record at the incoming iterate (TRACE_COLS layout): true
            # objective and primal infeasibility from the carried
            # trajectory, dual infeasibility max|Q_v|, accepted step
            # norm/size, AL penalty.
            cs_t = _constraints(cfg, _arrivals(zs, zN))
            tr_t = torch.cat([zs[:, 1:, 1], zN[:, 1:2]], dim=1) - ref[:, None]
            dv_t = v - zs[:, :, 5]
            obj_t = torch.sum(tr_t * tr_t, dim=1) \
                + cfg.rterm * torch.sum(dv_t * dv_t, dim=1)
            ys = torch.stack(
                [obj_t, torch.clamp_min(torch.amax(-cs_t, dim=(1, 2)), 0.0),
                 qmax, d_n, a_n, mu.expand(B)], dim=-1)
        return v_n, zs_n, zN_n, it_n, d_n, qmax, a_n, ys

    v, lam = state.v, state.lam
    zs, zN = _rollout_batch(cfg, x0, u_prev_s, v)
    mu = torch.full((), cfg.mu0, dtype=dtype, device=device)
    iters = torch.zeros(B, dtype=torch.int32, device=device)
    d_norm = torch.zeros(B, dtype=dtype, device=device)
    inf_du = torch.zeros(B, dtype=dtype, device=device)
    alpha = torch.zeros(B, dtype=dtype, device=device)
    traces = []
    for _ in range(cfg.al_iters):
        for _ in range(cfg.gn_iters):
            v, zs, zN, iters, d_norm, inf_du, alpha, ys = gn_iter(
                v, zs, zN, lam, mu, iters, alpha)
            traces.append(ys)
        # Constraints at the arrival states x_1..x_N.
        cs = _constraints(cfg, _arrivals(zs, zN))            # (B, N, nc)
        lam = torch.clamp_min(lam - mu * cs, 0.0)
        mu = mu * cfg.mu_factor

    if cfg.polish_iters > 0:
        # Active-set polish (sqp.polish): same NLP, same decision vector.
        # The stage-major (N, nc) multipliers map to the condensed solver's
        # type-major layout.
        lam_flat = lam.transpose(1, 2).reshape(B, -1)
        v = polish(cfg, x0, ref, u_prev_s, v, lam_flat)
        zs, zN = _rollout_batch(cfg, x0, u_prev_s, v)

    obj, inf_pr = _objective(cfg, zs, zN, v, ref)
    diag = Diagnostics(
        iters=iters,
        obj=obj,
        inf_pr=inf_pr,
        inf_du=inf_du,
        reg=torch.full((B,), cfg.lm_reg, dtype=dtype, device=device),
        d_norm=d_norm,
        mu=mu.expand(B).clone(),
        alpha=alpha,
        trace=torch.stack(traces, dim=1) if cfg.record_trace else None)
    return v[:, 0] * U_SCALE, ILQRState(v=v, lam=lam), diag


def solve(cfg: MPCConfig, x0, ref, u_prev, state: ILQRState):
    """One MPC solve via AL-iLQR: the B = 1 wrapper of :func:`solve_batch`."""
    dtype, device = state.v.dtype, state.v.device
    u0, st, diag = solve_batch(
        cfg, torch.as_tensor(x0, device=device).to(dtype)[None],
        torch.as_tensor(ref, dtype=dtype, device=device).reshape(1),
        torch.as_tensor(u_prev, dtype=dtype, device=device).reshape(1),
        ILQRState(v=state.v[None], lam=state.lam[None]))
    sq = lambda a: None if a is None else a[0]  # noqa: E731
    return sq(u0), ILQRState(v=st.v[0], lam=st.lam[0]), \
        Diagnostics(*(sq(a) for a in diag))
