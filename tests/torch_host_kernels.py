"""Kernels K4 (plant step), K5 (AL-iLQR solve) and the SQP's build and search
on the CPU, for the tests.

``csrc/host_bodies.cpp`` runs the kernels' per-scenario bodies
(``csrc/bodies.cuh`` on ``csrc/press_dual.cuh``, the same source that nvcc
compiles for the card) in a loop, built with ``g++ -O2 -ffp-contract=off``
by ``ops.build.build_host``.  The functions here drive it through the
wrappers' own checks and argument packing (``ops.plant.check`` /
``prepare``, ``ops.ilqr.check`` / ``prepare``), so a test holds the
kernels' arithmetic and the wrappers' layout against the plain versions and
the JAX package without a card.  A test that needs the library skips where
``g++`` is missing.
"""

import collections
import ctypes
import functools
import shutil

import pytest
import torch

from forging_control_tpu_torch.ops import build, ilqr, plant, smallchol, sqp
from forging_control_tpu_torch.solver import riccati
from forging_control_tpu_torch.solver import sqp as sqp_solver


@functools.cache
def _built():
    return build.build_host()


def lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++: the host build of the kernels' bodies")
    return _built()


def _fn(symbol, argtypes):
    fn = getattr(lib(), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def plant_host(cfg, x_true, x_meas, u, w, v, team=plant.TEAM):
    """(x_next, x_meas_next, Fd) from K4's body on the CPU, by a team of
    ``team`` lanes a scenario (1: the one-thread reference body)."""
    plant.check(x_true, x_meas, u, w, v, device_type="cpu", team=team)
    outs, args = plant.prepare(cfg, x_true, x_meas, u, w, v, team)
    rc = _fn(plant._SYMBOLS[x_true.dtype], plant._ARGTYPES[:-1])(*args)
    assert rc == 0
    return outs


def ilqr_host(kcfg, params, x0, ref, u_prev, v, lam,
              team=ilqr.TEAM) -> ilqr.Solved:
    """K5's outputs from its body on the CPU, at the kernel's configuration
    ``kcfg`` (``riccati.kernel_cfg``), a team of ``team`` lanes a
    scenario."""
    ilqr.check(kcfg, x0, ref, u_prev, v, lam, device_type="cpu", team=team)
    out, _zc, args = ilqr.prepare(kcfg, params, x0, ref, u_prev, v, lam,
                                  team)
    rc = _fn(ilqr._SYMBOLS[v.dtype], ilqr._ARGTYPES[:-1])(*args)
    assert rc == 0
    return out


# The SMs of the card whose team rule the routed dispatch follows (an
# H100's).
ROUTED_SMS = 132


def sweeps_host(reset=False) -> list[int]:
    """``ops.ilqr.kernel_sweeps`` for K5's body on the CPU: the host
    library's count of the iterations it computed, per AL round."""
    out = (ctypes.c_ulonglong * ilqr.SWEEP_ROUNDS)()
    rc = _fn("fct_ilqr_sweeps", (ctypes.POINTER(ctypes.c_ulonglong),
                                 ctypes.c_int))(out, int(reset))
    assert rc == 0
    return list(out)


def solve_host(cfg, x0, ref, u_prev, v, lam, team=ilqr.TEAM) -> ilqr.Solved:
    """:func:`ilqr_host` at an ``MPCConfig``: K5's rounds for ``cfg``."""
    return ilqr_host(riccati.kernel_cfg(cfg, v.shape[1]), cfg.params, x0,
                     ref, u_prev, v, lam, team)


def _dtype(v):
    return "f32" if v.dtype == torch.float32 else "f64"


def sqp_build_host(kcfg, params, x0, ref, u_prev, v_in, lam_in, bufs, step,
                   team=None):
    """The SQP build's body on the CPU (``ops.sqp.sqp_build_cuda``'s
    arguments), ``team`` lanes a scenario (default ``sqp.build_team``)."""
    sqp.check(kcfg, x0, ref, u_prev, v_in, lam_in, device_type="cpu")
    team = sqp.build_team(kcfg.N) if team is None else team
    ptrs = sqp.pointers(bufs, x0, ref, u_prev, v_in, lam_in)
    rc = _fn(f"fct_sqp_build_{_dtype(v_in)}", sqp._BUILD_ARGS[:-1])(
        *sqp.build_args(kcfg, params, ptrs, v_in.shape[0], step, team))
    assert rc == 0


def sqp_search_host(kcfg, params, x0, ref, u_prev, v_in, lam_in, x, bufs,
                    step, team=None):
    """The SQP search's body on the CPU (``ops.sqp.sqp_search_cuda``'s
    arguments), ``team`` lanes a scenario (default ``sqp.search_team``)."""
    sqp.check(kcfg, x0, ref, u_prev, v_in, lam_in, device_type="cpu")
    team = sqp.search_team(kcfg.n_lad + 2) if team is None else team
    ptrs = sqp.pointers(bufs, x0, ref, u_prev, v_in, lam_in, x.contiguous())
    rc = _fn(f"fct_sqp_search_{_dtype(v_in)}", sqp._SEARCH_ARGS[:-1])(
        *sqp.search_args(kcfg, params, ptrs, v_in.shape[0], step, team))
    assert rc == 0


def route_kernels_to_host(monkeypatch) -> collections.Counter:
    """Make the dispatch take the kernels for CPU tensors and run their
    bodies on the CPU: ``build.on_card`` says yes for the CPU, and the CUDA
    wrappers' launches go to the host library (B1's to its plain version).
    The routed launches count in ``build.LAUNCHES`` under the kernels'
    names, as ``build.launch`` counts them; that counter starts empty here
    and is returned.  K5 runs at the team size ``ilqr.team_size`` picks on
    a card of :data:`ROUTED_SMS` SMs; its sweep counter
    (``ilqr.kernel_sweeps``) reads the host library's."""
    lib()
    monkeypatch.setattr(build, "LAUNCHES", collections.Counter())
    on_card = build.on_card

    def cpu_is_card(device):
        return device.type == "cpu" or on_card(device)

    def ilqr_routed(*a, team=None):
        if team is None:
            v = a[5]
            team = ilqr.team_size(*v.shape, v.dtype, ROUTED_SMS)
        return ilqr_host(*a, team=team)

    def counted(name, fn):
        def run(*a, **kw):
            build.LAUNCHES[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(build, "on_card", cpu_is_card)
    monkeypatch.setattr(plant, "plant_step_cuda",
                        counted("plant", plant_host))
    monkeypatch.setattr(ilqr, "ilqr_cuda", counted("ilqr", ilqr_routed))
    monkeypatch.setattr(ilqr, "kernel_sweeps", sweeps_host)
    monkeypatch.setattr(sqp, "sqp_build_cuda",
                        counted("sqp_build", sqp_build_host))
    monkeypatch.setattr(sqp, "sqp_search_cuda",
                        counted("sqp_search", sqp_search_host))
    monkeypatch.setattr(sqp_solver, "chol_solve_cuda",
                        counted("smallchol", smallchol.chol_solve_torch))
    return build.LAUNCHES


def float64(*arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float64).contiguous()
                 for a in arrays)
