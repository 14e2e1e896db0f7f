"""Plain reference of the condensed Gauss-Newton SQP controller, in plain
PyTorch.

The same MPC as :mod:`.ilqr` (stage cost, pressure bounds through an
augmented Lagrangian, warm start shifted by one stage), condensed onto the
scaled input trajectory v alone: per iteration the residuals
[y_dot_k - ref (N), sqrt(rterm) (v_k - v_{k-1}) (N), AL terms (n_con)]
and their Jacobian over v by forward mode, g = J^T r, H = J^T J; the
damped normal systems (H + d I) s = g for the three dampings
(lm_reg, lm_reg + 0.01, lm_reg + 1) solved by Cholesky; candidate steps:
the first direction at each size of ``step_ladder``, then the other two
directions whole; the cheapest candidate is taken where it lowers the cost
and the scenario has not converged (max |g| < tol_grad).  After
``gn_iters`` iterations the multipliers take one AL update and the
penalty grows by ``mu_factor``; that ``al_iters`` times.

Rows are independent scenarios.  The dtype of the inputs is the dtype of
the arithmetic.  It imports nothing of the program under test.
"""

from __future__ import annotations

import math

import torch

from . import physics as ph


def n_con(cfg) -> int:
    return cfg["horizon"] * (2 if cfg.get("p_max") is None else 4)


def init_state(cfg, rows: int, dtype):
    return (torch.zeros(rows, cfg["horizon"], dtype=dtype),
            torch.zeros(rows, n_con(cfg), dtype=dtype))


def _residuals(cfg, x0, ref, us, lam, mu, v):
    """(r, c): the stacked residuals and the raw constraints, type-major
    [p1 (N), p2 (N)(, hi - p1, hi - p2)], of the inputs v (an N-tuple of
    tensors or duals) from x0 (5-tuple)."""
    N = cfg["horizon"]
    x, p1s, p2s, tr = x0, [], [], []
    for k in range(N):
        x = ph.rk4(x, v[k] * ph.U_SCALE, cfg["dt"], cfg["substeps"])
        tr.append(x[1] - ref)
        p1s.append(x[2] / ph.P_SCALE)
        p2s.append(x[3] / ph.P_SCALE)
    lo = cfg["p_min"] / ph.P_SCALE
    cons = [p - lo for p in p1s] + [p - lo for p in p2s]
    if cfg.get("p_max") is not None:
        hi = cfg["p_max"] / ph.P_SCALE
        cons += [hi - p for p in p1s] + [hi - p for p in p2s]
    rt = math.sqrt(cfg["rterm"])
    vs = [us] + list(v)
    du = [rt * (vs[k + 1] - vs[k]) for k in range(N)]
    rc = [math.sqrt(mu / 2.0) * ph.maximum(lam[..., i] / mu - c, 0.0)
          for i, c in enumerate(cons)]
    return ph.stack(tr + du + rc), ph.stack(cons)


def chol_solve(H, g):
    """x with H x = g, H (..., n, n) symmetric positive definite, by an
    unblocked Cholesky factorisation and two triangular solves."""
    n = H.shape[-1]
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, -1)


def solve(cfg, state, x0, ref, u_prev):
    """One MPC solve for rows of measured states x0 (R, 5), references
    ref (R,) and previous inputs u_prev (R,), from the warm start
    ``state`` (v (R, N), lam (R, n_con)) as the previous period left it.
    Returns (u (R,), the new state)."""
    v, lam = state
    v = torch.cat([v[:, 1:], v[:, -1:]], 1)            # shift
    R, N = v.shape
    dt = v.dtype
    us = u_prev / ph.U_SCALE
    x0t = tuple(x0[:, i] for i in range(5))
    ladder = tuple(cfg["step_ladder"])
    alphas = torch.tensor(ladder + (1.0, 1.0), dtype=dt)
    nC = len(alphas)
    regs = torch.tensor([cfg["lm_reg"], cfg["lm_reg"] + 1e-2,
                         cfg["lm_reg"] + 1.0], dtype=dt)
    eye = torch.eye(N, dtype=dt)
    rows = torch.arange(R)
    x0c = tuple(a[:, None].expand(R, nC) for a in x0t)
    mu = float(cfg["mu0"])
    for _ in range(cfg["al_iters"]):
        for _ in range(cfg["gn_iters"]):
            out, _ = _residuals(cfg, x0t, ref, us, lam, mu, ph.seed(v))
            r, J = ph.jacobian(out)                    # (R, m), (R, m, N)
            g = torch.einsum("bri,br->bi", J, r)
            H = torch.einsum("bri,brj->bij", J, J)
            cost0 = 0.5 * (r * r).sum(-1)
            gnorm = g.abs().amax(-1)
            converged = gnorm < cfg["tol_grad"]
            s = chol_solve(H[:, None] + regs[None, :, None, None] * eye,
                           g[:, None, :].expand(R, 3, N))
            dirs = -torch.cat([s[:, :1].expand(R, len(ladder), N), s[:, 1:]],
                              1)
            vs = v[:, None] + alphas[None, :, None] * dirs   # (R, C, N)
            rt, _ = _residuals(cfg, x0c, ref[:, None], us[:, None],
                               lam[:, None], mu, vs.unbind(-1))
            costs = 0.5 * (rt * rt).sum(-1)
            best = torch.argmin(costs, 1)
            take = (costs[rows, best] < cost0) & ~converged
            v = torch.where(take[:, None], vs[rows, best], v)
        _, c = _residuals(cfg, x0t, ref, us, lam, mu, v.unbind(-1))
        lam = torch.clamp_min(lam - mu * c, 0.0)
        mu = mu * cfg["mu_factor"]
    return v[:, 0] * ph.U_SCALE, (v, lam)
