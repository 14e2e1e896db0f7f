"""Plain reference of the AL-iLQR controller, in plain PyTorch.

The MPC of the deployment: horizon N, scaled input trajectory v (u = 0.01
v), the stage cost rterm (v_k - v_{k-1})^2 + (y_dot_{k} - ref)^2 on the
states the RK4 model predicts, the pressure bounds p >= p_min (and
p <= p_max where set) through an augmented Lagrangian, solved by
Gauss-Newton iLQR over the augmented state z = [x, v_prev]: per
iteration a backward Riccati sweep over the 6 x 6 blocks (Levenberg
damping ``lm_reg``), a forward pass that tries the step sizes ALPHAS on
the feedforward term and keeps the cheapest, accepted only where it lowers
the cost and the scenario has not converged (max |Q_v| < tol_grad); after
``gn_iters`` iterations the multipliers take one AL update and the penalty
grows by ``mu_factor``; that ``al_iters`` times.  Between periods the
solution is shifted by one stage (warm start).

Rows are independent scenarios.  The dtype of the inputs is the dtype of
the arithmetic.  It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from . import physics as ph

ALPHAS = (1.0, 0.5, 0.1, 0.02)


def n_con(cfg) -> int:
    return 2 if cfg.get("p_max") is None else 4


def init_state(cfg, rows: int, dtype):
    N = cfg["horizon"]
    return (torch.zeros(rows, N, dtype=dtype),
            torch.zeros(rows, N, n_con(cfg), dtype=dtype))


def _cons(cfg, p1, p2):
    """Pressure inequalities c >= 0 in scaled units (list of nc)."""
    lo = cfg["p_min"] / ph.P_SCALE
    out = [p1 / ph.P_SCALE - lo, p2 / ph.P_SCALE - lo]
    if cfg.get("p_max") is not None:
        hi = cfg["p_max"] / ph.P_SCALE
        out += [hi - p1 / ph.P_SCALE, hi - p2 / ph.P_SCALE]
    return out


def _al(c, lam_i, mu):
    return math.sqrt(mu / 2.0) * ph.maximum(lam_i / mu - c, 0.0)


def _step(cfg, z, v):
    """Augmented dynamics: z (6-tuple) and v -> the next z (6-tuple)."""
    x = ph.rk4(z[:5], v * ph.U_SCALE, cfg["dt"], cfg["substeps"])
    return (*x, v)


def _stage_res(cfg, z, v, ref, lam, mu):
    """[sqrt(rterm) (v - v_prev), y_dot - ref, AL terms] (list)."""
    cs = _cons(cfg, z[2], z[3])
    return ([math.sqrt(cfg["rterm"]) * (v - z[5]), z[1] - ref]
            + [_al(c, lam[..., i], mu) for i, c in enumerate(cs)])


def _term_res(cfg, z, ref, lam, mu):
    cs = _cons(cfg, z[2], z[3])
    return [z[1] - ref] + [_al(c, lam[..., i], mu) for i, c in enumerate(cs)]


def _tup(z):
    return tuple(z[..., i] for i in range(z.shape[-1]))


def _rollout(cfg, z0, v):
    """Departure states (R, N, 6) and the terminal state (R, 6)."""
    z, zs = _tup(z0), []
    for k in range(v.shape[1]):
        zs.append(torch.stack(z, -1))
        z = _step(cfg, z, v[:, k])
    return torch.stack(zs, 1), torch.stack(z, -1)


def solve(cfg, state, x0, ref, u_prev):
    """One MPC solve for rows of measured states x0 (R, 5), references
    ref (R,) and previous inputs u_prev (R,), from the warm start
    ``state`` (v (R, N), lam (R, N, nc)) as the previous period left it.
    Returns (u (R,), the new state)."""
    v, lam = state
    v = torch.cat([v[:, 1:], v[:, -1:]], 1)            # shift
    R, N = v.shape
    dt = v.dtype
    nc = n_con(cfg)
    nr = 2 + nc
    z0 = torch.cat([x0, (u_prev / ph.U_SCALE)[:, None]], -1)
    zs, zN = _rollout(cfg, z0, v)
    mu = float(cfg["mu0"])
    alphas = torch.tensor(ALPHAS, dtype=dt)
    mask = torch.ones(N, nr, dtype=dt)
    mask[0, 1:] = 0.0           # stage 0: only the input-move term
    rows = torch.arange(R)
    for _ in range(cfg["al_iters"]):
        for _ in range(cfg["gn_iters"]):
            lam_dep = torch.cat([torch.zeros(R, 1, nc, dtype=dt),
                                 lam[:, :-1]], 1)
            # Every stage linearised at once: 7 tangents (z, v).
            zv = ph.seed(torch.cat([zs, v[..., None]], -1))
            out, J = ph.jacobian(ph.stack(
                list(_step(cfg, zv[:6], zv[6]))
                + _stage_res(cfg, zv[:6], zv[6], ref[:, None], lam_dep, mu)))
            r = out[..., 6:] * mask                    # J: (R, N, 6 + nr, 7)
            Amat, Bv = J[..., :6, :6], J[..., :6, 6]
            Jz = J[..., 6:, :6] * mask[..., None]
            Jv = J[..., 6:, 6] * mask
            rN, JzN = ph.jacobian(ph.stack(
                _term_res(cfg, ph.seed(zN), ref, lam[:, -1], mu)))
            cost0 = (r * r).sum((1, 2)) + (rN * rN).sum(1)

            lz = 2.0 * torch.einsum("bkri,bkr->bki", Jz, r)
            lv = 2.0 * (Jv * r).sum(-1)
            Lzz = 2.0 * torch.einsum("bkri,bkrj->bkij", Jz, Jz)
            Lvv = 2.0 * (Jv * Jv).sum(-1)
            Lvz = 2.0 * torch.einsum("bkr,bkri->bki", Jv, Jz)
            Vz = 2.0 * torch.einsum("bri,br->bi", JzN, rN)
            Vzz = 2.0 * torch.einsum("bri,brj->bij", JzN, JzN)
            qmax = torch.zeros(R, dtype=dt)
            kg, Kg = [None] * N, [None] * N
            for k in reversed(range(N)):
                A, Bk = Amat[:, k], Bv[:, k]
                Qz = lz[:, k] + torch.einsum("bji,bj->bi", A, Vz)
                Qv = lv[:, k] + (Bk * Vz).sum(-1)
                Qzz = Lzz[:, k] + torch.einsum(
                    "bji,bjk,bkl->bil", A, Vzz, A)
                VB = torch.einsum("bjk,bk->bj", Vzz, Bk)
                Qvv = Lvv[:, k] + (Bk * VB).sum(-1) + cfg["lm_reg"]
                Qvz = Lvz[:, k] + torch.einsum("bj,bji->bi", VB, A)
                kg[k] = -Qv / Qvv
                Kg[k] = -Qvz / Qvv[:, None]
                Vz = Qz + Kg[k] * Qv[:, None] + Qvz * kg[k][:, None] \
                    + Kg[k] * (Qvv * kg[k])[:, None]
                Vzz = Qzz + Kg[k][:, :, None] * Qvz[:, None, :] \
                    + Qvz[:, :, None] * Kg[k][:, None, :] \
                    + Qvv[:, None, None] * Kg[k][:, :, None] \
                    * Kg[k][:, None, :]
                qmax = torch.maximum(qmax, Qv.abs())
            converged = qmax < cfg["tol_grad"]

            # Forward pass: every step size at once, (A, R) rows.
            nA = len(ALPHAS)
            z = _tup(z0[None].expand(nA, R, 6))
            cost = torch.zeros(nA, R, dtype=dt)
            v_c, z_c = [], []
            for k in range(N):
                zt = torch.stack(z, -1)
                vk = v[None, :, k] + alphas[:, None] * kg[k][None] \
                    + torch.einsum("bi,abi->ab", Kg[k], zt - zs[None, :, k])
                rk = torch.stack(_stage_res(cfg, z, vk, ref[None],
                                            lam_dep[None, :, k], mu), -1)
                if k == 0:
                    rk = rk * mask[0]
                cost = cost + (rk * rk).sum(-1)
                v_c.append(vk)
                z_c.append(zt)
                z = _step(cfg, z, vk)
            rNc = torch.stack(_term_res(cfg, z, ref[None], lam[None, :, -1],
                                        mu), -1)
            costs = cost + (rNc * rNc).sum(-1)
            best = torch.argmin(costs, 0)
            take = (costs[best, rows] < cost0) & ~converged
            v = torch.where(take[:, None], torch.stack(v_c, -1)[best, rows],
                            v)
            zs = torch.where(take[:, None, None],
                             torch.stack(z_c, 2)[best, rows], zs)
            zN = torch.where(take[:, None],
                             torch.stack(z, -1)[best, rows], zN)
        arr = torch.cat([zs[:, 1:], zN[:, None]], 1)
        cs = torch.stack(_cons(cfg, arr[..., 2], arr[..., 3]), -1)
        lam = torch.clamp_min(lam - mu * cs, 0.0)
        mu = mu * cfg["mu_factor"]
    return v[:, 0] * ph.U_SCALE, (v, lam)
