"""Plain reference of the closed loop: the plant driven by given commands,
and the controller followed period by period on given states.

A period of the deployment: the controller reads the measured state and
the previous command and returns u_t; the plant takes one RK4 period of
dx/dt = f(x, u_t) + w_t from the true state, and the measurement of the
new state (the smooth variant's floored pressures) is the next period's
measured state.  The controller's warm start is its own solution of the
previous period, shifted.

Every function works on rows of independent scenarios in the dtype of its
inputs, on the CPU.  It imports nothing of the program under test.
"""

from __future__ import annotations

import importlib

import torch

from . import physics as ph


def solver(cfg):
    """The reference controller module of the configuration's backend
    (``benchmark/reference/<backend>.py``)."""
    return importlib.import_module(f"{__package__}.{cfg['backend']}")


def replay(cfg, x0, u, w):
    """The plant driven by commands u (R, T) and process noise w (R, T, 5)
    from true states x0 (R, 5): the measured states (R, T + 1, 5), the
    first being x0's measurement."""
    x = tuple(x0[:, i] for i in range(5))
    out = [torch.stack(ph.measure(x), -1)]
    for t in range(u.shape[1]):
        x = ph.rk4(x, u[:, t], cfg["dt"], cfg["substeps"],
                   tuple(w[:, t, i] for i in range(5)))
        out.append(torch.stack(ph.measure(x), -1))
    return torch.stack(out, 1)


def start(cfg, u_prev, hot):
    """The controller's state to start following from, for rows of
    previous commands u_prev (R,): the configuration's cold start, or
    where ``hot`` (R,) is set the hot start, every stage of the warm start
    at the previous command (the multipliers at zero, as cold)."""
    v, *rest = solver(cfg).init_state(cfg, u_prev.shape[0], u_prev.dtype)
    v = torch.where(hot[:, None], (u_prev / ph.U_SCALE)[:, None], v)
    return (v, *rest)


def follow(cfg, xm, ref, u_prev, state=None):
    """The controller's commands (R, L) on given measured states xm
    (R, L, 5), references ref (R, L) and previous commands u_prev (R, L),
    period after period from ``state`` (a cold start by default), its warm
    start carried from its own solves.  Returns (commands, final state)."""
    mod = solver(cfg)
    if state is None:
        state = mod.init_state(cfg, xm.shape[0], xm.dtype)
    us = []
    for t in range(xm.shape[1]):
        u, state = mod.solve(cfg, state, xm[:, t], ref[:, t], u_prev[:, t])
        us.append(u)
    return torch.stack(us, 1), state


def closed_loop(cfg, x0, ref, w, u_init=0.0):
    """The whole closed loop from true states x0 (R, 5) over references
    ref (R, T) with process noise w (R, T, 5): (commands (R, T), measured
    states after each period (R, T, 5))."""
    mod = solver(cfg)
    R, T = ref.shape
    state = mod.init_state(cfg, R, x0.dtype)
    x = tuple(x0[:, i] for i in range(5))
    u = torch.full((R,), float(u_init), dtype=x0.dtype)
    us, xs = [], []
    for t in range(T):
        u, state = mod.solve(cfg, state, torch.stack(ph.measure(x), -1),
                             ref[:, t], u)
        x = ph.rk4(x, u, cfg["dt"], cfg["substeps"],
                   tuple(w[:, t, i] for i in range(5)))
        us.append(u)
        xs.append(torch.stack(ph.measure(x), -1))
    return torch.stack(us, 1), torch.stack(xs, 1)
