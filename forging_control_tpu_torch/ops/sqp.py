"""The condensed GN-SQP's Gauss-Newton iteration — the build and the line
search, around kernel B1.

Wrappers of the hand-written CUDA kernels ``csrc/sqp_build.cu`` and
``csrc/sqp_search.cu`` (their bodies: ``csrc/sqp_bodies.cuh`` on the
device physics of ``csrc/press_dual.cuh``).  One Gauss-Newton iteration of
:func:`forging_control_tpu_torch.solver.sqp.solve_batch` on a card is three
launches: the build writes the three damped normal systems into B1's
inputs, B1 (:func:`~forging_control_tpu_torch.ops.smallchol.chol_solve_cuda`)
solves them, and the search takes the step; an AL round's last search also
updates the multipliers, and the solve's last writes the diagnostics.  They
are the counterpart of the XLA program that the JAX package compiles from
its ``solve_batch`` (``forging_control_tpu/solver/sqp.py``), which has no
Pallas kernel besides B1's.

The plain version is the tensor code of ``solver/sqp.py`` itself
(``linsolve="plain"``, and every solve on the CPU).

:func:`allocate` makes the outputs and the scratch of one solve;
:func:`schedule` lists its launches; :func:`sqp_build_cuda` and
:func:`sqp_search_cuda` check their inputs, pick the team size from what
they see (the build: G = N lanes a scenario, one input direction each; the
search: a lane per candidate), take the configuration's scalars as kernel
arguments (so a captured control period makes no tensor from host data and
reads nothing back) and launch on the current stream (``build.launch``,
which counts them under their sources' names).  N is bounded by B1's 25.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import build
from .ilqr import Solved
from .plant import VARIANTS, press_params_c
from .smallchol import MAX_N
from ..physics.scaling import U_SCALE

WARP = 32
MAX_CAND = 64                  # csrc/sqp_bodies.cuh kSqpMaxCand
# SqpFlags of csrc/sqp_bodies.cuh.
FIRST, STEP, ROUND_END, LAST = 1, 2, 4, 8


class Step(NamedTuple):
    """One build and search: the AL round, the trace row (-1: none) and the
    flags (:data:`FIRST`, :data:`STEP`, :data:`ROUND_END`, :data:`LAST`)."""

    al: int
    row: int
    flags: int


def schedule(al_iters: int, gn_iters: int, record_trace: bool = False) \
        -> tuple[Step, ...]:
    """The launches of one solve, in order: a :class:`Step` a Gauss-Newton
    iteration (each a build, B1 and a search), and, where a round has no
    Gauss-Newton iteration or the solve no round, a build and a search
    without a step, for the AL update and the diagnostics at the iterate."""
    steps = []

    def add(al, row, flags):
        steps.append(Step(al, row, flags | (0 if steps else FIRST)))

    for al in range(al_iters):
        last = LAST if al == al_iters - 1 else 0
        for gn in range(gn_iters):
            end = ROUND_END | last if gn == gn_iters - 1 else 0
            add(al, al * gn_iters + gn if record_trace else -1, STEP | end)
        if gn_iters == 0:
            add(al, -1, ROUND_END | last)
    if al_iters == 0:
        add(0, -1, LAST)
    return tuple(steps)


def build_team(N: int) -> int:
    """Lanes a scenario of the build: one an input direction (the fastest
    at N = 10, B = 4,096 on an H100 against 16 or 32 lanes, and against two
    or four directions a lane; PERF.md)."""
    return N


def search_team(n_cand: int) -> int:
    """Lanes a scenario of the search: one a candidate, at most a warp."""
    return min(n_cand, WARP)


def teams_per_block(G: int) -> int:
    """Teams of G lanes a block of one warp holds."""
    return WARP // G


class SqpCfgC(ctypes.Structure):
    """``fct::SqpCfg`` of ``csrc/sqp_bodies.cuh``."""

    _fields_ = [("dt", ctypes.c_double), ("substeps", ctypes.c_int),
                ("variant", ctypes.c_int), ("N", ctypes.c_int),
                ("nc", ctypes.c_int), ("n_lad", ctypes.c_int),
                ("trace_rows", ctypes.c_int)] \
        + [(name, ctypes.c_double) for name in (
            "sqrt_rterm", "rterm", "p_scale", "p_lo", "p_hi", "mu0",
            "mu_factor", "tol_grad", "lm_reg", "u_scale")] \
        + [("regs", ctypes.c_double * 3),
           ("alphas", ctypes.c_double * MAX_CAND)]


@functools.lru_cache(maxsize=None)
def sqp_cfg_c(cfg, N: int, p_scale: float) -> SqpCfgC:
    """The kernels' view of an ``MPCConfig`` at horizon N with the
    solver's pressure scale.  Each derived constant is computed as
    ``solver/sqp.py`` computes it in Python: the dampings of ``_damping``,
    the candidates' step sizes (the ladder, then 1.0 twice).  Cached, so the
    structure outlives every launch that points to it."""
    if cfg.variant not in VARIANTS:
        raise ValueError(f"unknown variant: {cfg.variant!r}")
    ladder = tuple(cfg.step_ladder)
    if len(ladder) + 2 > MAX_CAND:
        raise ValueError(f"the SQP kernels take a step ladder of at most "
                         f"{MAX_CAND - 2} rungs, got {len(ladder)}")
    alphas = ladder + (1.0, 1.0)
    return SqpCfgC(
        dt=cfg.dt, substeps=cfg.substeps, variant=VARIANTS[cfg.variant],
        N=N, nc=2 if cfg.p_max is None else 4, n_lad=len(ladder),
        trace_rows=cfg.al_iters * cfg.gn_iters if cfg.record_trace else 0,
        sqrt_rterm=math.sqrt(cfg.rterm), rterm=cfg.rterm, p_scale=p_scale,
        p_lo=cfg.p_min / p_scale,
        p_hi=0.0 if cfg.p_max is None else cfg.p_max / p_scale,
        mu0=cfg.mu0, mu_factor=cfg.mu_factor, tol_grad=cfg.tol_grad,
        lm_reg=cfg.lm_reg, u_scale=U_SCALE,
        regs=(ctypes.c_double * 3)(cfg.lm_reg, cfg.lm_reg + 1e-2,
                                   cfg.lm_reg + 1.0),
        alphas=(ctypes.c_double * MAX_CAND)(*alphas))


class Buffers(NamedTuple):
    """One solve's outputs (a :class:`~.ilqr.Solved`, ``lam`` (B, nc N)
    type-major as the SQP keeps it) and scratch: B1's systems ``H``
    (B, 3, N, N) and ``g`` (B, 3, N), the work rows (B, 4 + nc N: cost0,
    the largest |g_i|, the iterate's objective, infeasibility and
    constraint values) and the candidates' constraint values ``cs``
    (B, n_lad + 2, nc N)."""

    out: Solved
    H: torch.Tensor
    g: torch.Tensor
    work: torch.Tensor
    cs: torch.Tensor


def allocate(kcfg, v) -> Buffers:
    """:class:`Buffers` for a solve from the iterate ``v`` (B, N) at the
    configuration ``kcfg`` (a :class:`SqpCfgC`)."""
    B, N = v.shape
    dtype, device = v.dtype, v.device
    like = lambda *shape: torch.empty(*shape, dtype=dtype,  # noqa: E731
                                      device=device)
    ncon = kcfg.nc * N
    out = Solved(
        u0=like(B), v=like(B, N), lam=like(B, ncon),
        iters=torch.empty(B, dtype=torch.int32, device=device),
        obj=like(B), inf_pr=like(B), inf_du=like(B), reg=like(B),
        d_norm=like(B), mu=like(B), alpha=like(B),
        trace=like(B, kcfg.trace_rows, 6) if kcfg.trace_rows else None)
    return Buffers(out=out, H=like(B, 3, N, N), g=like(B, 3, N),
                   work=like(B, 4 + ncon),
                   cs=like(B, kcfg.n_lad + 2, ncon))


_DTYPES = {torch.float32: "f32", torch.float64: "f64"}


def check(kcfg, x0, ref, u_prev, v, lam, device_type: str = "cuda") -> None:
    """Raise unless the inputs are what the kernels take at ``kcfg``:
    tensors on one ``device_type`` device of one dtype (float32 or
    float64), x0 (B, 5), ref and u_prev (B,), v (B, N) with N = kcfg.N and
    1 <= N <= 25 (B1's limit), lam (B, nc N), contiguous, none requiring a
    gradient."""
    named = {"x0": x0, "ref": ref, "u_prev": u_prev, "v": v, "lam": lam}
    for k, a in named.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"sqp kernels: {k} must be a tensor, got "
                            f"{type(a).__name__}")
    if v.device.type != device_type or any(a.device != v.device
                                           for a in named.values()):
        raise ValueError(f"the sqp kernels need {device_type} tensors on "
                         f"one device, got "
                         f"{[str(a.device) for a in named.values()]}")
    if v.dtype not in _DTYPES or any(a.dtype != v.dtype
                                     for a in named.values()):
        raise TypeError(f"the sqp kernels take float32 or float64 of one "
                        f"dtype, got {[a.dtype for a in named.values()]}")
    if v.dim() != 2:
        raise ValueError(f"sqp kernels: v has shape {tuple(v.shape)}, "
                         f"expected (B, N)")
    B, N = v.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"the sqp kernels support 1 <= N <= {MAX_N} (B1 "
                         f"solves the damped systems), got N={N}")
    if N != kcfg.N:
        raise ValueError(f"sqp kernels: v has horizon {N}, the "
                         f"configuration {kcfg.N}")
    want = {"x0": (B, 5), "ref": (B,), "u_prev": (B,), "v": (B, N),
            "lam": (B, kcfg.nc * N)}
    for k, a in named.items():
        if tuple(a.shape) != want[k]:
            raise ValueError(f"sqp kernels: {k} has shape "
                             f"{tuple(a.shape)}, expected {want[k]}")
        if not a.is_contiguous():
            raise ValueError(f"the sqp kernels take contiguous tensors ({k} "
                             f"is not)")
        if a.requires_grad:
            raise RuntimeError("the sqp kernels have no backward; pass "
                               "tensors that do not require a gradient")
    if kcfg.substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {kcfg.substeps}")


def pointers(bufs: Buffers, x0, ref, u_prev, v_in, lam_in, x=None):
    """The C interface's array of 22 pointers (``fct::SqpIO`` order) for a
    launch that reads the iterate (v_in, lam_in) and, in the search, B1's
    solutions x (B, 3, N); the outputs of :func:`allocate`'s ``bufs``."""
    o = bufs.out
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    return (ctypes.c_void_p * 22)(*map(ptr, (
        x0, ref, u_prev, v_in, lam_in, o.v, o.lam, bufs.H, bufs.g, x,
        bufs.work, bufs.cs, o.iters, o.d_norm, o.alpha, o.inf_du, o.trace,
        o.u0, o.obj, o.inf_pr, o.mu, o.reg)))


SOURCES = ("sqp_build", "sqp_search")


@functools.cache
def _entry(name: str, symbol: str, argtypes: tuple):
    """A kernel's entry point; the first call builds both sources together
    (one nvcc each, started at once)."""
    build.build_all(SOURCES)
    return build.entry(name, symbol, argtypes)


_BUILD_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 \
    + (ctypes.c_void_p,)
_SEARCH_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 6 \
    + (ctypes.c_void_p,)


def build_args(kcfg, params, ptrs, B: int, step: Step, team: int):
    """The build's C arguments without the stream."""
    return (ctypes.addressof(press_params_c(params)), ctypes.addressof(kcfg),
            ptrs, B, team, teams_per_block(team), step.al, step.row)


def search_args(kcfg, params, ptrs, B: int, step: Step, team: int):
    """The search's C arguments without the stream."""
    return build_args(kcfg, params, ptrs, B, step, team) + (step.flags,)


def _team(team, default: int, lo: int) -> int:
    team = default if team is None else team
    if not lo <= team <= WARP:
        raise ValueError(f"sqp kernels: team must lie in {lo}..{WARP}, got "
                         f"{team}")
    return team


def sqp_build_cuda(kcfg, params, x0, ref, u_prev, v_in, lam_in,
                   bufs: Buffers, step: Step, team: int | None = None) -> None:
    """The build of one Gauss-Newton iteration at the iterate (v_in,
    lam_in): the damped systems into ``bufs.H`` and ``bufs.g``, the work
    rows and the trace row's columns at the incoming iterate.  CUDA
    tensors as :func:`check` takes them; ``team`` lanes a scenario (at
    least N; default :func:`build_team`)."""
    check(kcfg, x0, ref, u_prev, v_in, lam_in)
    team = _team(team, build_team(kcfg.N), kcfg.N)
    fn = _entry("sqp_build", f"fct_sqp_build_{_DTYPES[v_in.dtype]}",
                _BUILD_ARGS)
    ptrs = pointers(bufs, x0, ref, u_prev, v_in, lam_in)
    build.launch("sqp_build", fn, v_in.device,
                 *build_args(kcfg, params, ptrs, v_in.shape[0], step, team))


def sqp_search_cuda(kcfg, params, x0, ref, u_prev, v_in, lam_in, x,
                    bufs: Buffers, step: Step,
                    team: int | None = None) -> None:
    """The line search of one Gauss-Newton iteration from B1's solutions
    ``x`` (B, 3, N; the steps are -x) after the build of the same
    iteration: the new iterate into ``bufs.out.v``, the diagnostics and,
    as ``step.flags`` say, the multipliers and the solve's last outputs.
    ``team`` lanes a scenario (default :func:`search_team`)."""
    check(kcfg, x0, ref, u_prev, v_in, lam_in)
    if x.shape != bufs.g.shape or x.dtype != v_in.dtype \
            or x.device != v_in.device or not x.is_contiguous():
        raise ValueError(f"sqp_search_cuda: x must be contiguous "
                         f"{tuple(bufs.g.shape)} of the iterate's dtype and "
                         f"device, got {tuple(x.shape)}")
    team = _team(team, search_team(kcfg.n_lad + 2), 1)
    fn = _entry("sqp_search", f"fct_sqp_search_{_DTYPES[v_in.dtype]}",
                _SEARCH_ARGS)
    ptrs = pointers(bufs, x0, ref, u_prev, v_in, lam_in, x)
    build.launch("sqp_search", fn, v_in.device,
                 *search_args(kcfg, params, ptrs, v_in.shape[0], step, team))
