"""The program under test, as the drivers reach it: the port's closed-loop
entries ``loop.closed_loop.run_batch`` and ``make_stepper``, with the
controller and loop settings of a configuration file.  Nothing else of the
port is called."""

from __future__ import annotations

import dataclasses

import torch
from forging_control_tpu_torch.loop.closed_loop import (LoopConfig,
                                                         MPCController,
                                                         make_stepper,
                                                         run_batch as _run)
from forging_control_tpu_torch.solver.sqp import MPCConfig

_SOLVER_KEYS = ("horizon", "dt", "substeps", "variant", "rterm", "p_min",
                "p_max", "gn_iters", "al_iters", "mu0", "mu_factor",
                "tol_grad", "lm_reg")


def objects(cfg: dict):
    """(LoopConfig, MPCController) of a configuration file."""
    mpc = MPCConfig(**{k: cfg[k] for k in _SOLVER_KEYS},
                    step_ladder=tuple(cfg["step_ladder"]))
    loop = LoopConfig(t_steps=cfg["t_steps"], dt=cfg["dt"],
                      substeps=cfg["substeps"], variant=cfg["variant"],
                      process_std=tuple(cfg["process_std"]),
                      meas_std=tuple(cfg["meas_std"]))
    return loop, MPCController(mpc, backend=cfg["backend"],
                               linsolve=cfg["linsolve"])


def run_batch(cfg, loop_cfg, ctrl, x0, refs, noise, device):
    """One call of the batched closed loop over the references' periods
    with pre-drawn process noise; returns (final state, telemetry)."""
    if loop_cfg.t_steps != refs.shape[1]:
        loop_cfg = dataclasses.replace(loop_cfg, t_steps=refs.shape[1])
    return _run(loop_cfg, ctrl, x0, refs, process_noise=noise,
                u_init=cfg["u_init"], device=device)


def stepper(cfg, loop_cfg, ctrl, device):
    """The single-stream stepper at B = 1 and its first carry."""
    return make_stepper(loop_cfg, ctrl, x0=cfg["x0"], u_init=cfg["u_init"],
                        dtype=getattr(torch, cfg["dtype"]), device=device)
