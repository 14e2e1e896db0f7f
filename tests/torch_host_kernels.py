"""Kernels K4 (plant step) and K5 (AL-iLQR solve) on the CPU, for the tests.

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

import ctypes
import functools
import shutil

import pytest
import torch

from forging_control_tpu_torch.ops import build, ilqr, plant
from forging_control_tpu_torch.solver import riccati


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


def solve_host(cfg, x0, ref, u_prev, v, lam, team=ilqr.TEAM) -> ilqr.Solved:
    """:func:`ilqr_host` at an ``MPCConfig``: K5's rounds for ``cfg``."""
    return ilqr_host(riccati.kernel_cfg(cfg, v.shape[1]), cfg.params, x0,
                     ref, u_prev, v, lam, team)


def route_kernels_to_host(monkeypatch) -> dict:
    """Make the dispatch take the kernels for CPU tensors and run their
    bodies on the CPU: ``build.on_card`` says yes for the CPU, and the CUDA
    wrappers' launches go to the host library.  Returns the launch counts
    of the two kernels, which the patched wrappers keep."""
    lib()
    counts = {"plant": 0, "ilqr": 0}
    on_card = build.on_card

    def cpu_is_card(device):
        return device.type == "cpu" or on_card(device)

    def plant_cuda(*a):
        counts["plant"] += 1
        return plant_host(*a)

    def ilqr_cuda(*a):
        counts["ilqr"] += 1
        return ilqr_host(*a)

    monkeypatch.setattr(build, "on_card", cpu_is_card)
    monkeypatch.setattr(plant, "plant_step_cuda", plant_cuda)
    monkeypatch.setattr(ilqr, "ilqr_cuda", ilqr_cuda)
    return counts


def float64(*arrays):
    return tuple(torch.as_tensor(a, dtype=torch.float64).contiguous()
                 for a in arrays)
