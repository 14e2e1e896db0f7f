"""The operations that kernels K4 and K5 and the SQP's build and search need
for given inputs.

The kernels' per-scenario bodies (``csrc/bodies.cuh``) run on the CPU on a
scalar that does the arithmetic and counts it (``csrc/op_count.h``, built
into the host library by :func:`ops.build.build_host`): an operation counts
where it needs arithmetic on a value that depends on the inputs, so
branches not taken, structurally zero tangents and operations on constants
cost nothing.  The count is what the operations bound of a kernel divides
by the card's rate (``chip_smoke.py``).  The functions take the kernels'
own inputs on the CPU and return the outputs beside the counts, which equal
the host build's outputs bit for bit.  No path of the port calls them.
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from . import build, ilqr, plant, sqp

# The bodies' phases (FCT_PHASE in csrc/bodies.cuh), by kernel.
PLANT_PHASES = ("forging force", "RK4", "clip and measurement")
ILQR_PHASES = ("initial rollout", "stage RK4 with tangents",
               "residuals and Gauss-Newton blocks", "backward sweep",
               "forward sweep", "accept, AL update and diagnostics")
SQP_BUILD_PHASES = ("RK4 with a tangent", "residual rows and sums",
                    "normal equations", "cost, gradient norm and trace")
SQP_SEARCH_PHASES = ("candidates' steps", "RK4", "residuals and costs",
                     "accept, AL update and diagnostics")


@functools.cache
def _fn(symbol: str, argtypes: tuple):
    fn = getattr(build.build_host(), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _threads(threads):
    return max(1, min(8, os.cpu_count() or 1)) if threads is None else threads


def _by_phase(ops, names) -> dict:
    return {"total": int(sum(ops)),
            "by_phase": {n: int(ops[i]) for i, n in enumerate(names)}}


def plant_ops(cfg, x_true, x_meas, u, w, v, threads=None, team=1):
    """((x_next, x_meas_next, Fd), counts) of K4's body on these CPU
    tensors (``ops.plant.plant_step_cuda``'s arguments); ``counts`` is
    ``{"total": n, "by_phase": {...}, "depth": {...}}`` over
    :data:`PLANT_PHASES`.  ``team`` 1 (the default) runs the reference
    body ``plant_body``, whose count is the function's; ``team`` 4 runs the
    team body ``plant_team``, which computes both sides of every select and
    every lane's part.  ``depth`` is the longest chain of
    dependent operations over the scenarios (``csrc/op_count.h``):
    ``"period"`` to any output, ``"by_phase"`` the deepest value each phase
    reaches from the inputs, and ``"per_stage"`` the RK4's depth over its
    4 x substeps evaluations of rhs."""
    plant.check(x_true, x_meas, u, w, v, device_type="cpu", team=team)
    outs, args = plant.prepare(cfg, x_true, x_meas, u, w, v, team)
    dtype = "f32" if x_true.dtype == torch.float32 else "f64"
    ops = (ctypes.c_ulonglong * 8)()
    depth = (ctypes.c_ulonglong * 8)()
    fn = _fn(f"fct_plant_ops_{dtype}",
             plant._ARGTYPES[:-1]
             + (ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
                ctypes.POINTER(ctypes.c_ulonglong)))
    if fn(*args, _threads(threads), ops, depth) != 0:
        raise ValueError("fct_plant_ops refused its arguments")
    counts = _by_phase(ops, PLANT_PHASES)
    by_phase = {n: int(depth[i]) for i, n in enumerate(PLANT_PHASES)}
    counts["depth"] = {
        "period": max(by_phase.values()), "by_phase": by_phase,
        "per_stage": by_phase["RK4"] / (4 * cfg.substeps)}
    return outs, counts


def ilqr_ops(kcfg, params, x0, ref, u_prev, v, lam, threads=None,
             executed=False, team=ilqr.TEAM):
    """(outputs, counts) of K5's body on these CPU tensors
    (``ops.ilqr.ilqr_cuda``'s arguments): the outputs an
    :class:`ops.ilqr.Solved`, ``counts`` ``{"total": n, "by_phase":
    {...}}`` over :data:`ILQR_PHASES`: the function's operations, each
    value counted once, every iteration run.  With ``executed``,
    ``counts["executed"]`` is the same reading for what the kernel runs:
    its linearisation units each evaluate their stage's values again, and
    it skips the iterations that repeat a step not taken, and at
    ``team`` 16 or 32 its rollouts run on quads of four lanes (K4's
    ``rhs_four``: both sides of each select, every lane of every quad).
    The function's count does not depend on ``team``: it takes the
    one-lane rollouts (``csrc/host_bodies.cpp`` ``ilqr_ops``)."""
    ilqr.check(kcfg, x0, ref, u_prev, v, lam, device_type="cpu", team=team)
    out, _zc, args = ilqr.prepare(kcfg, params, x0, ref, u_prev, v, lam,
                                  team)
    dtype = "f32" if v.dtype == torch.float32 else "f64"
    ops = (ctypes.c_ulonglong * 8)()
    exec_ops = (ctypes.c_ulonglong * 8)() if executed else None
    fn = _fn(f"fct_ilqr_ops_{dtype}",
             ilqr._ARGTYPES[:-1]
             + (ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong),
                ctypes.POINTER(ctypes.c_ulonglong)))
    if fn(*args, _threads(threads), ops, exec_ops) != 0:
        raise ValueError("fct_ilqr_ops refused its arguments")
    counts = _by_phase(ops, ILQR_PHASES)
    if executed:
        counts["executed"] = _by_phase(exec_ops, ILQR_PHASES)
    return out, counts


def _dtype(v):
    return "f32" if v.dtype == torch.float32 else "f64"


def sqp_build_ops(kcfg, params, x0, ref, u_prev, v, lam, bufs, step,
                  threads=None, team=None):
    """The counts of the SQP build's body on these CPU tensors
    (``ops.sqp.sqp_build_cuda``'s arguments; its outputs land in ``bufs``
    as the host build writes them): ``{"total", "by_phase"}`` over
    :data:`SQP_BUILD_PHASES`, what the kernel runs with ``team`` lanes (each
    of its N working lanes its own values); ``"function"``, the same for one
    lane with every input
    direction (the values and what the tangent rules derive from them
    counted once, as ``dual.linearize`` computes them); and ``"values"``,
    one lane's values alone, which each further lane of the kernel
    computes again (``csrc/host_bodies.cpp`` ``sqp_build_ops``)."""
    sqp.check(kcfg, x0, ref, u_prev, v, lam, device_type="cpu")
    team = sqp.build_team(kcfg.N) if team is None else team
    ptrs = sqp.pointers(bufs, x0, ref, u_prev, v, lam)
    ops, fn_ops, val_ops = ((ctypes.c_ulonglong * 8)() for _ in range(3))
    fn = _fn(f"fct_sqp_build_ops_{_dtype(v)}",
             sqp._BUILD_ARGS[:-1]
             + (ctypes.c_int,) + (ctypes.POINTER(ctypes.c_ulonglong),) * 3)
    if fn(*sqp.build_args(kcfg, params, ptrs, v.shape[0], step, team),
          _threads(threads), ops, fn_ops, val_ops) != 0:
        raise ValueError("fct_sqp_build_ops refused its arguments")
    counts = _by_phase(ops, SQP_BUILD_PHASES)
    counts["function"] = _by_phase(fn_ops, SQP_BUILD_PHASES)
    counts["values"] = _by_phase(val_ops, SQP_BUILD_PHASES)
    return counts


def sqp_search_ops(kcfg, params, x0, ref, u_prev, v, lam, x, bufs, step,
                   threads=None, team=None):
    """The counts of the SQP search's body on these CPU tensors
    (``ops.sqp.sqp_search_cuda``'s arguments; its outputs land in
    ``bufs``): ``{"total", "by_phase"}`` over :data:`SQP_SEARCH_PHASES`,
    which is the function's (each candidate on one lane)."""
    sqp.check(kcfg, x0, ref, u_prev, v, lam, device_type="cpu")
    team = sqp.search_team(kcfg.n_lad + 2) if team is None else team
    ptrs = sqp.pointers(bufs, x0, ref, u_prev, v, lam, x.contiguous())
    ops = (ctypes.c_ulonglong * 8)()
    fn = _fn(f"fct_sqp_search_ops_{_dtype(v)}",
             sqp._SEARCH_ARGS[:-1]
             + (ctypes.c_int, ctypes.POINTER(ctypes.c_ulonglong)))
    if fn(*sqp.search_args(kcfg, params, ptrs, v.shape[0], step, team),
          _threads(threads), ops) != 0:
        raise ValueError("fct_sqp_search_ops refused its arguments")
    return _by_phase(ops, SQP_SEARCH_PHASES)

