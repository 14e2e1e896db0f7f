"""The whole AL-iLQR solve — kernel K5.

Wrapper of the hand-written CUDA kernel ``csrc/ilqr.cu``: one launch runs
:func:`forging_control_tpu_torch.solver.riccati.solve_batch`'s rounds for
every scenario, a team of G lanes per scenario whose blocks live in shared
memory (the body is ``csrc/bodies.cuh`` ``ilqr_team`` on the device physics
of ``csrc/press_dual.cuh``).  It is the counterpart of the JAX package's
compiled ``riccati.solve_batch``
(``forging_control_tpu/solver/riccati.py:148-359``), whose scans XLA
compiles into one program; the JAX package has no Pallas kernel for it.

The plain version is the tensor code of ``solver/riccati.py``, which also
dispatches (:func:`~forging_control_tpu_torch.solver.riccati.solve_batch`,
``solver="kernel"`` or ``"plain"``) and runs the active-set polish after
the kernel where the configuration asks for it.

:func:`ilqr_cuda` checks its inputs, allocates every output, picks the
launch geometry (the team size from the batch, :func:`team_size`, and the
teams a block holds), takes the configuration's scalars as kernel arguments
(so a captured control period makes no tensor from host data and reads
nothing back) and launches on the current stream (``build.launch``, which
counts it under ``"ilqr"``).  The horizon is bounded by one scenario's blocks in
a block's shared memory (:func:`max_horizon`): N <= 536 in float32, 267 in
float64.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build
from ..physics.scaling import U_SCALE
from .plant import VARIANTS, plant_consts_at, press_params_c

# Lanes a scenario (G): the sizes the kernel is built for, which team_size
# picks from (float64: TEAM alone), and TEAM, float64's and that of a batch
# that fills the card (the fastest at N = 10, B = 4,096, and at N = 25 over
# both strokes, on an H100; PERF.md).
TEAMS = (8, 16, 32)
TEAM = 8
WARP = 32
# What an SM of the card the kernel is built for (sm_90) holds of it: 64 K
# registers, so 8 warps at the kernel's 255 registers a thread (blocks of
# one warp); 228 KB of shared memory, of which the system reserves 1 KB a
# block.
SM_WARPS = 8
SM_SHARED_BYTES = 228 * 1024
BLOCK_RESERVED_BYTES = 1024
# The AL rounds whose sweeps the kernel counts apart (csrc/bodies.cuh
# kSweepRounds; later rounds add to the last).
SWEEP_ROUNDS = 8
# Dynamic shared memory a block may use: the 227 KB a block may opt in to,
# less the block's sweep sums (csrc/bodies.cuh kIlqrSharedBytes).
SHARED_BYTES = 227 * 1024 - 4 * SWEEP_ROUNDS


def team_fields(N: int) -> int:
    """Values of one scenario's blocks in shared memory at horizon N
    (``csrc/bodies.cuh`` ``IlqrLayout``, an odd number)."""
    return 108 * N + 185


def zc_fields(N: int) -> int:
    """Values of one scenario's candidate states in device memory."""
    return 24 * N


def max_horizon(dtype: torch.dtype) -> int:
    """The largest N whose blocks fit a block's shared memory in
    ``dtype`` (float32 or float64)."""
    size = torch.empty((), dtype=dtype).element_size()
    N = 1
    while team_fields(N + 1) * size <= SHARED_BYTES:
        N += 1
    return N


def teams_per_block(N: int, dtype: torch.dtype, team: int = TEAM) -> int:
    """Teams of ``team`` lanes a block of the kernel holds at horizon N: as
    many as fill one warp, fewer where their blocks would pass the shared
    memory a block may use.  (Fuller blocks beat more of them: at N = 25 on
    an H100, 3 teams of 8 a block keep 18 teams on an SM against 16 and
    take longer, PERF.md.)"""
    size = torch.empty((), dtype=dtype).element_size()
    return max(1, min(WARP // team, SHARED_BYTES // (team_fields(N) * size)))


def resident_teams(N: int, dtype: torch.dtype, team: int) -> int:
    """Teams of ``team`` lanes that one SM holds at once at horizon N in
    ``dtype``: blocks of :func:`teams_per_block` teams, as many as the
    registers (:data:`SM_WARPS` blocks of one warp) and the shared memory
    (the teams' blocks, the block's sweep sums and the system's reserve)
    allow."""
    size = torch.empty((), dtype=dtype).element_size()
    per_block = teams_per_block(N, dtype, team)
    block_bytes = (per_block * team_fields(N) * size + 4 * SWEEP_ROUNDS
                   + BLOCK_RESERVED_BYTES)
    return per_block * max(1, min(SM_WARPS, SM_SHARED_BYTES // block_bytes))


@functools.lru_cache(maxsize=None)
def team_size(B: int, N: int, dtype: torch.dtype, sms: int) -> int:
    """The kernel's team size for B scenarios at horizon N in ``dtype`` on a
    card of ``sms`` SMs: in float32 the largest of 32 and 16 whose single
    wave (``sms`` x :func:`resident_teams`) holds all B, where a scenario's
    two rollouts run on quads of four lanes; else :data:`TEAM`, the only
    size float64 is built for.  On an H100 (132 SMs) at N = 10: 32 up to
    1,056 scenarios, 16 up to 2,112, then 8; at N = 25 the same edges."""
    if dtype == torch.float32:
        for team in (32, 16):
            if B <= sms * resident_teams(N, dtype, team):
                return team
    return TEAM


@functools.cache
def sm_count(index: int) -> int:
    """The SMs of card ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def default_team(v: torch.Tensor) -> int:
    """The team size for a launch on ``v`` (B, N): :func:`team_size` on a
    card, from its SM count; :data:`TEAM` for CPU tensors (the host build's
    tests), where there is no card to fill."""
    if v.device.type != "cuda":
        return TEAM
    B, N = v.shape
    return team_size(B, N, v.dtype, sm_count(v.device.index))


class IlqrCfgC(ctypes.Structure):
    """``fct::IlqrCfg`` of ``csrc/bodies.cuh``."""

    _fields_ = [("dt", ctypes.c_double), ("substeps", ctypes.c_int),
                ("variant", ctypes.c_int), ("N", ctypes.c_int),
                ("nc", ctypes.c_int), ("gn_iters", ctypes.c_int),
                ("al_iters", ctypes.c_int), ("record_trace", ctypes.c_int)] \
        + [(name, ctypes.c_double) for name in (
            "sqrt_rterm", "rterm", "p_scale", "p_lo", "p_hi", "mu0",
            "mu_factor", "tol_grad", "lm_reg", "u_scale")] \
        + [("alphas", ctypes.c_double * 4)]


@functools.lru_cache(maxsize=None)
def ilqr_cfg_c(cfg, N: int, nc: int, p_scale: float,
               alphas: tuple) -> IlqrCfgC:
    """The kernel's view of an ``MPCConfig`` at horizon N, with the
    solver's constants: nc constraints a stage, the pressure scale and the
    line search's step ladder.  Each derived constant is computed as
    ``solver/riccati.py`` computes it in Python (cached, so the structure
    outlives every launch that points to it)."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant: {cfg.variant!r}")
    return IlqrCfgC(
        dt=cfg.dt, substeps=cfg.substeps, variant=VARIANTS[cfg.variant],
        N=N, nc=nc, gn_iters=cfg.gn_iters, al_iters=cfg.al_iters,
        record_trace=int(bool(cfg.record_trace)),
        sqrt_rterm=math.sqrt(cfg.rterm), rterm=cfg.rterm,
        p_scale=p_scale, p_lo=cfg.p_min / p_scale,
        p_hi=0.0 if cfg.p_max is None else cfg.p_max / p_scale,
        mu0=cfg.mu0, mu_factor=cfg.mu_factor, tol_grad=cfg.tol_grad,
        lm_reg=cfg.lm_reg, u_scale=U_SCALE,
        alphas=(ctypes.c_double * 4)(*alphas))


class Solved(NamedTuple):
    """The kernel's outputs, (B, ...) each: the first command (physical
    units), the solution and multipliers, and the ``Diagnostics`` leaves
    (``trace`` None unless the configuration records it)."""

    u0: torch.Tensor
    v: torch.Tensor
    lam: torch.Tensor
    iters: torch.Tensor
    obj: torch.Tensor
    inf_pr: torch.Tensor
    inf_du: torch.Tensor
    reg: torch.Tensor
    d_norm: torch.Tensor
    mu: torch.Tensor
    alpha: torch.Tensor
    trace: torch.Tensor | None


_SYMBOLS = {torch.float32: "fct_ilqr_f32", torch.float64: "fct_ilqr_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def check(kcfg, x0, ref, u_prev, v, lam, device_type: str = "cuda",
          team: int | None = None) -> None:
    """Raise unless the inputs are what the kernel takes at the
    configuration ``kcfg`` (an :class:`IlqrCfgC`) with teams of ``team``
    lanes (one of :data:`TEAMS`; None: :func:`default_team`): tensors on
    one ``device_type`` device of
    one dtype (float32 or float64), x0 (B, 5), ref and u_prev (B,), v
    (B, N) with N = kcfg.N and 1 <= N <= :func:`max_horizon` of the dtype,
    lam (B, N, kcfg.nc), contiguous, none requiring a gradient."""
    named = {"x0": x0, "ref": ref, "u_prev": u_prev, "v": v, "lam": lam}
    for k, a in named.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"ilqr_cuda: {k} must be a tensor, got "
                            f"{type(a).__name__}")
    if v.device.type != device_type or any(a.device != v.device
                                           for a in named.values()):
        raise ValueError(f"ilqr_cuda needs {device_type} tensors on one "
                         f"device, got "
                         f"{[str(a.device) for a in named.values()]}")
    if v.dtype not in _SYMBOLS or any(a.dtype != v.dtype
                                      for a in named.values()):
        raise TypeError(f"ilqr_cuda takes float32 or float64 of one dtype, "
                        f"got {[a.dtype for a in named.values()]}")
    if v.dim() != 2:
        raise ValueError(f"ilqr_cuda: v has shape {tuple(v.shape)}, "
                         f"expected (B, N)")
    B, N = v.shape
    limit = max_horizon(v.dtype)
    if not 1 <= N <= limit:
        raise ValueError(f"ilqr_cuda supports 1 <= N <= {limit} in "
                         f"{v.dtype} (one scenario's blocks in "
                         f"{SHARED_BYTES} bytes of shared memory), got N={N}")
    if team is None:
        team = default_team(v)
    if team not in TEAMS:
        raise ValueError(f"ilqr_cuda: team must be one of {TEAMS}, got "
                         f"{team}")
    if device_type == "cuda" and v.dtype == torch.float64 and team != TEAM:
        raise ValueError(f"ilqr_cuda: float64 is built for team {TEAM} "
                         f"only, got {team}")
    if N != kcfg.N:
        raise ValueError(f"ilqr_cuda: v has horizon {N}, the configuration "
                         f"{kcfg.N}")
    nc = kcfg.nc
    want = {"x0": (B, 5), "ref": (B,), "u_prev": (B,), "v": (B, N),
            "lam": (B, N, nc)}
    for k, a in named.items():
        if tuple(a.shape) != want[k]:
            raise ValueError(f"ilqr_cuda: {k} has shape {tuple(a.shape)}, "
                             f"expected {want[k]}")
        if not a.is_contiguous():
            raise ValueError(f"ilqr_cuda takes contiguous tensors ({k} is "
                             f"not)")
        if a.requires_grad:
            raise RuntimeError("ilqr_cuda has no backward; pass tensors "
                               "that do not require a gradient")
    if kcfg.substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {kcfg.substeps}")


def prepare(kcfg, params, x0, ref, u_prev, v, lam, team: int | None = None):
    """The outputs (a :class:`Solved`) and the candidates' states'
    scratch, allocated, and the C arguments of one launch without the
    stream, at the configuration ``kcfg``, the press parameters ``params``
    (and K4's constants at the solver's dt and substeps, which the
    rollouts read at G >= 16) and teams of ``team`` lanes (None:
    :func:`default_team`), as many as :func:`teams_per_block` puts in a
    block."""
    B, N = v.shape
    dtype, device = v.dtype, v.device
    if team is None:
        team = default_team(v)
    like = lambda *shape: torch.empty(*shape, dtype=dtype,  # noqa: E731
                                      device=device)
    rounds = kcfg.al_iters * kcfg.gn_iters
    out = Solved(
        u0=like(B), v=torch.empty_like(v), lam=torch.empty_like(lam),
        iters=torch.empty(B, dtype=torch.int32, device=device),
        obj=like(B), inf_pr=like(B), inf_du=like(B), reg=like(B),
        d_norm=like(B), mu=like(B), alpha=like(B),
        trace=like(B, rounds, 6) if kcfg.record_trace else None)
    zc = like(zc_fields(N) * B)
    ptrs = (ctypes.c_void_p * 18)(*(
        None if a is None else a.data_ptr() for a in (
            x0, ref, u_prev, v, lam, *out, zc)))
    args = (ctypes.addressof(press_params_c(params)),
            ctypes.addressof(kcfg),
            plant_consts_at(params, kcfg.dt, kcfg.substeps, dtype), ptrs,
            B, team, teams_per_block(N, dtype, team))
    return out, zc, args


def ilqr_cuda(kcfg, params, x0, ref, u_prev, v, lam,
              team: int | None = None) -> Solved:
    """Kernel K5: the AL-iLQR rounds of ``solver/riccati.py`` at the
    configuration ``kcfg`` (an :class:`IlqrCfgC`, which
    ``riccati.kernel_cfg`` builds) and the press parameters ``params``, for
    B scenarios from the warm start (v, lam), with the initial states x0,
    the references and the previous commands u_prev (physical units), all
    contiguous CUDA tensors of one dtype (see :func:`check`); ``team``
    lanes a scenario (None: :func:`team_size` for this batch and card).
    The active-set polish is not the kernel's: ``riccati.solve_batch`` runs
    it after the launch."""
    check(kcfg, x0, ref, u_prev, v, lam, team=team)
    fn = build.entry("ilqr", _SYMBOLS[v.dtype], _ARGTYPES)
    out, _zc, args = prepare(kcfg, params, x0, ref, u_prev, v, lam, team)
    build.launch("ilqr", fn, v.device, *args)
    return out


def kernel_sweeps(reset: bool = False) -> list[int]:
    """The Gauss-Newton iterations K5 computed on the current card since
    its library was loaded (or last reset), summed over scenarios, per AL
    round (:data:`SWEEP_ROUNDS` values, the later rounds in the last): an
    iteration counts where the kernel ran its linearisation, backward sweep
    and forward pass, and not where it skipped a repeat of an iteration
    that took no step (``Diagnostics.iters`` counts those too).  With
    ``reset`` the count starts again from 0.  Synchronises the card."""
    return build.kernel_counter("ilqr", "sweeps", SWEEP_ROUNDS, reset)
