"""Native realtime runtime — ctypes bindings, without jax.

Port of ``forging_control_tpu/runtime/__init__.py``: the C++ closed-loop
executor (FNN policy + plant at the 1 ms period), the single-stream native
GN-SQP MPC and the OpenMP batch generator.  The port keeps its own copy of
the C++ sources in ``runtime/src`` (held byte-identical to the JAX
package's by ``tests/test_torch_runtime.py``) and builds it at first use with
``g++ -O3 -march=native -fopenmp -shared -fPIC`` into
``build/native_runtime/libforging_rt-<hash>.so`` beside the package (a
directory that ``.gitignore`` lists), never beside the sources.  The hash
covers the sources, the flags and the host's CPU (``-march=native`` code
runs only where it was built).  A missing ``g++`` or a failed build raises
:class:`NativeBuildError`.

* :func:`build` / :func:`load` — compile / load the library
* :class:`NativeMPC` — warm-started native GN-SQP, one solve per call
* :class:`RealtimeExecutor` — episode runner for a trained FNN policy
* :func:`mpc_generate_batch`, :class:`TrajStore` — batch datasets
* :func:`rhs` / :func:`rk4` — native physics hooks for parity tests
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np
import torch

SOURCE_DIR = Path(__file__).resolve().parent / "src"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native_runtime"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

VARIANTS = {"raw": 0, "smooth": 1, "clamp": 2}

_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native runtime could not be built (no ``g++``, or it failed)."""


def _host_cpu() -> bytes:
    """The host's CPU model and flags (what ``-march=native`` targets)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        lines = []
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return (platform.machine() + "\n".join(sorted(set(keep)))).encode()


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _host_cpu())
    for src in sorted(SOURCE_DIR.iterdir()):
        digest.update(src.name.encode() + src.read_bytes())
    return BUILD_DIR / f"libforging_rt-{digest.hexdigest()[:16]}.so"


def build(force: bool = False) -> Path:
    """Compile the runtime library unless it is built; returns its path."""
    out = library_path()
    if out.exists() and not force:
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not found: the native runtime needs a "
                               "C++ compiler with OpenMP")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [gxx, *GXX_FLAGS, str(SOURCE_DIR / "executor.cpp"), "-o", str(tmp)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        D = ctypes.c_double
        P = ctypes.POINTER(D)
        I64P = ctypes.POINTER(ctypes.c_int64)
        lib.fc_create.restype = ctypes.c_void_p
        lib.fc_create.argtypes = [ctypes.c_int, D, ctypes.c_int]
        lib.fc_destroy.argtypes = [ctypes.c_void_p]
        lib.fc_reset.argtypes = [ctypes.c_void_p, P]
        lib.fc_load_policy.restype = ctypes.c_int
        lib.fc_load_policy.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            P, P, P, P, P, P, P, D, D, D, D]
        lib.fc_plant_step.argtypes = [ctypes.c_void_p, D, P, P]
        lib.fc_step.restype = D
        lib.fc_step.argtypes = [ctypes.c_void_p, D, P, P, I64P]
        lib.fc_run_episode.argtypes = [
            ctypes.c_void_p, P, P, ctypes.c_int, P, P, I64P]
        lib.fc_rhs.argtypes = [ctypes.c_int, P, D, P]
        lib.fc_rk4.argtypes = [ctypes.c_int, P, D, D, ctypes.c_int]
        lib.fc_mpc_create.restype = ctypes.c_void_p
        lib.fc_mpc_create.argtypes = [ctypes.c_int, D, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_int, D]
        lib.fc_mpc_create_ex.restype = ctypes.c_void_p
        lib.fc_mpc_create_ex.argtypes = [ctypes.c_int, D, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int, D, D,
                                         D, D]
        lib.fc_mpc_destroy.argtypes = [ctypes.c_void_p]
        lib.fc_mpc_reset.argtypes = [ctypes.c_void_p]
        lib.fc_mpc_step.restype = D
        lib.fc_mpc_step.argtypes = [ctypes.c_void_p, P, D, D, P]
        lib.fc_mpc_run_episode.argtypes = [
            ctypes.c_void_p, P, P, ctypes.c_int, P, P, I64P]
        lib.fc_mpc_run_batch.restype = ctypes.c_int
        lib.fc_mpc_run_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, P, P, ctypes.c_int,
            ctypes.c_int, P, P, ctypes.c_char_p]
        _lib = lib
    return _lib


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _f64(a) -> np.ndarray:
    """A C-contiguous float64 copy of a tensor or array."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(a, np.float64)


def rhs(x, u, variant="smooth") -> np.ndarray:
    lib = load()
    x = _f64(x)
    out = np.empty(5)
    lib.fc_rhs(VARIANTS[variant], _dp(x), float(u), _dp(out))
    return out


def rk4(x, u, dt=1e-3, substeps=4, variant="smooth") -> np.ndarray:
    lib = load()
    x = _f64(x).copy()
    lib.fc_rk4(VARIANTS[variant], _dp(x), float(u), float(dt), int(substeps))
    return x


class NativeMPC:
    """Native single-stream GN-SQP MPC (see src/sqp_solver.h).

    The real-time deployment path: warm-started solves at the 1 ms control
    period on a CPU.
    """

    def __init__(self, horizon=10, dt=1e-3, substeps=4, gn_iters=5,
                 al_iters=2, p_max=None, p_min=0.0, mu0=1e2, mu_factor=10.0,
                 preset=None):
        """preset="ipopt_compat" applies the recorded-IPOPT parity settings
        (p_min=-5e6, mu0=1, mu_factor=1 — sqp.MPCConfig.ipopt_compat)."""
        if preset == "ipopt_compat":
            p_min, mu0, mu_factor = -5e6, 1.0, 1.0
        elif preset is not None:
            raise ValueError(f"unknown preset {preset!r}")
        self._lib = load()
        self._h = self._lib.fc_mpc_create_ex(
            horizon, dt, substeps, gn_iters, al_iters,
            -1.0 if p_max is None else float(p_max), float(p_min),
            float(mu0), float(mu_factor))
        if not self._h:
            raise ValueError(
                f"fc_mpc_create failed (horizon must be 1..25, got {horizon})")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fc_mpc_destroy(self._h)
            self._h = None

    def reset(self):
        self._lib.fc_mpc_reset(self._h)

    def step(self, x_meas, ref, u_prev):
        """One warm-started solve; returns (u0, stats dict)."""
        x = _f64(x_meas)
        stats = np.zeros(4)
        u = self._lib.fc_mpc_step(self._h, _dp(x), float(ref),
                                  float(u_prev), _dp(stats))
        return u, {"iters": int(stats[0]), "obj": stats[1],
                   "inf_pr": stats[2], "inf_du": stats[3]}

    def run_episode(self, x0, refs):
        """Native closed loop (solver + RK4 plant).  Returns
        (xs (T,5) measurements, us (T,), solve latency ns (T,))."""
        refs, x0 = _f64(refs), _f64(x0)
        T = len(refs)
        xs, us = np.empty((T, 5)), np.empty(T)
        lat = np.empty(T, np.int64)
        self._lib.fc_mpc_run_episode(
            self._h, _dp(x0), _dp(refs), T, _dp(xs), _dp(us),
            lat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return xs, us, lat


def mpc_generate_batch(x0, refs, horizon=10, gn_iters=5, al_iters=2,
                       store_path=None):
    """OpenMP-parallel native MPC dataset generation (one solver/thread).

    Args:
      x0: (5,) initial state shared by all trajectories.
      refs: (n_traj, T) reference streams.
      store_path: optional trajectory-store file (see TrajStore).

    Returns (xs (n_traj, T, 5) measurements, us (n_traj, T)).
    """
    lib = load()
    refs, x0 = _f64(refs), _f64(x0)
    n, T = refs.shape
    xs, us = np.empty((n, T, 5)), np.empty((n, T))
    done = lib.fc_mpc_run_batch(
        horizon, gn_iters, al_iters, _dp(x0), _dp(refs), n, T, _dp(xs),
        _dp(us), store_path.encode() if store_path else None)
    if done != n:
        raise RuntimeError(f"batch generation failed: {done}/{n}")
    return xs, us


class TrajStore:
    """Zero-copy reader for the native trajectory store (trajstore.h)."""

    HEADER = 4 + 4 * 4
    NAMELEN = 16

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic != b"FCTS":
                raise ValueError(f"bad magic {magic!r}")
            ver, n, t, c = struct.unpack("<4I", f.read(16))
            if ver != 1:
                raise ValueError(f"unsupported version {ver}")
            self.n_traj, self.t_steps, self.n_cols = n, t, c
            self.columns = []
            for _ in range(c):
                raw = f.read(self.NAMELEN)
                self.columns.append(raw.split(b"\0", 1)[0].decode())
        offset = self.HEADER + self.n_cols * self.NAMELEN
        self.data = np.memmap(path, dtype=np.float64, mode="r",
                              offset=offset,
                              shape=(self.n_traj, self.t_steps, self.n_cols))

    def column(self, name):
        return self.data[..., self.columns.index(name)]

    def to_results_dict(self):
        """Reference result-dict schema (Generate Data/Functions.py:381-390)."""
        return {c: np.asarray(self.column(c)) for c in self.columns}


class RealtimeExecutor:
    """Native closed-loop runner for a trained FNN policy."""

    def __init__(self, variant="smooth", dt=1e-3, substeps=4):
        self._lib = load()
        self._h = self._lib.fc_create(VARIANTS[variant], dt, substeps)
        if not self._h:
            raise MemoryError("fc_create failed")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.fc_destroy(self._h)
            self._h = None

    def load_fnn_policy(self, params, in_scaler, out_scaler, width_dim=1,
                        lb=None, ub=None):
        """Load FNN params (``nn/fnn.py`` layout, tensors or arrays) and
        scalers.  lb/ub None means no explicit saturation (hardtanh x
        out-scale is the only bound, as in ``nn.fnn.make_policy``)."""
        lb = -1e30 if lb is None else lb
        ub = 1e30 if ub is None else ub
        w_in, b_in = _f64(params["w_in"]), _f64(params["b_in"])
        w_int, b_int = _f64(params["w_int"]), _f64(params["b_int"])
        w_out = _f64(params["w_out"]).ravel()
        hid = w_in.shape[1]
        in_shift = np.ascontiguousarray(np.broadcast_to(
            _f64(in_scaler.shift), (3,)))
        in_scale = np.ascontiguousarray(np.broadcast_to(
            _f64(in_scaler.scale), (3,)))
        out_shift = float(_f64(out_scaler.shift).ravel()[0])
        out_scale = float(_f64(out_scaler.scale).ravel()[0])
        rc = self._lib.fc_load_policy(
            self._h, 3, hid, width_dim, _dp(w_in), _dp(b_in), _dp(w_int),
            _dp(b_int), _dp(w_out), _dp(in_shift), _dp(in_scale),
            out_shift, out_scale, lb, ub)
        if rc != 0:
            raise ValueError(f"fc_load_policy failed: {rc}")

    def run_episode(self, x0, refs):
        """Run T closed-loop steps natively.

        Returns (xs (T,5) measurements, us (T,), latency_ns (T,))."""
        refs, x0 = _f64(refs), _f64(x0)
        T = len(refs)
        xs, us = np.empty((T, 5)), np.empty(T)
        lat = np.empty(T, np.int64)
        self._lib.fc_run_episode(
            self._h, _dp(x0), _dp(refs), T, _dp(xs), _dp(us),
            lat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return xs, us, lat
