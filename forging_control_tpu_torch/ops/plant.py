"""The closed loop's plant step — kernel K4.

One control period of the plant, the plant side of
``loop.closed_loop._period``: the forging force at the pre-step measured
state, RK4 of ``press.rhs`` from the true state with the command and the
additive process noise, the optional state clip (``nan_to_num``, then
clip), and the measurement of the new state plus its noise.  The JAX package
leaves this to XLA inside its compiled closed-loop scan
(``forging_control_tpu/loop/closed_loop.py:254-279``); it has no Pallas
kernel.  Three functions:

* :func:`plant_step_torch` — the plain version: the tensor code of the
  closed loop, the CPU path, and the reference of the kernel on the card;
* :func:`plant_step_cuda` — the wrapper of the hand-written CUDA kernel
  ``csrc/plant.cu``: a team of four lanes per scenario (the body is
  ``csrc/bodies.cuh`` ``plant_team`` on ``csrc/press_dual.cuh``), or, with
  ``team=1``, one thread per scenario through the reference body
  ``plant_body``, which gives the same bits.  It checks its inputs,
  allocates the outputs and launches on the current stream
  (``build.launch``, which counts it under ``"plant"``; :func:`sqrt_cuda`
  exposes the team body's square root for the card's check, counted under
  ``"plant sqrt"``);
* :func:`plant_step` — dispatch: the kernel on a card, the plain version on
  the CPU and wherever autograd records through the step (plant-in-loop
  training backpropagates through the plant; the kernel has no backward).

``cfg`` is a ``loop.closed_loop.LoopConfig``, or anything with its fields
``params``, ``variant``, ``dt``, ``substeps`` and ``state_clip``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from . import build
from .. import dual as ad
from ..integrate.rk4 import rk4_step
from ..physics import press

VARIANTS = {"raw": 0, "smooth": 1, "clamp": 2}
# Lanes of one warp a scenario: 1 runs the one-thread reference body
# (plant_body), 4 the team body (plant_team), the default.
TEAMS = (1, 4)
TEAM = 4


class PressParamsC(ctypes.Structure):
    """``fct::PressParams`` of ``csrc/press_dual.cuh``: the fields of
    ``press.PressParams`` that the physics reads, and the constants that
    ``press.py`` derives from them in Python, in double."""

    _fields_ = [(name, ctypes.c_double) for name in (
        "M", "B", "FT", "G", "KB", "KL_1", "KL_2", "PS", "PT", "T1",
        "MU", "K", "W0", "H0", "B0", "M0", "M2", "M3", "M4",
        "eps_y", "eps_q", "A1", "A2", "A_spread",
        "y_hi", "exp_m1t", "c_p1", "c_p2", "coeff", "s_orf", "lin_den",
        "v1h", "v2h", "smooth_eps", "A_m1", "M2_m1", "M3_m1")]


@functools.lru_cache(maxsize=None)
def press_params_c(params: press.PressParams) -> PressParamsC:
    """The kernels' view of ``params``, each derived constant computed as
    ``press.py`` computes it (cached per parameter set, so the structure
    outlives every launch that points to it)."""
    p = params
    s = 2.0 / p.RHO
    own = {f: getattr(p, f) for f in (
        "M", "B", "FT", "G", "KB", "KL_1", "KL_2", "PS", "PT", "T1", "MU",
        "K", "W0", "H0", "B0", "M0", "M2", "M3", "M4", "eps_y", "eps_q",
        "A1", "A2", "A_spread")}
    return PressParamsC(
        **own,
        y_hi=p.H0 * (1.0 - 1e-9), exp_m1t=math.exp(p.M1 * p.T),
        c_p1=3.0 * math.pi * p.D1 ** 2, c_p2=math.pi * p.D2 ** 2,
        coeff=math.pi * p.D * p.CD, s_orf=s,
        lin_den=math.sqrt(s * p.eps_q), v1h=p.V1_0 / 2.0, v2h=p.V2_0 / 2.0,
        smooth_eps=press._SMOOTH_EPS, A_m1=p.A_spread - 1.0,
        M2_m1=p.M2 - 1.0, M3_m1=p.M3 - 1.0)


# The press constants of the team body (csrc/bodies.cuh PlantConsts), in
# its order: PressParamsC fields rounded to the dtype, then each number that
# the body divides by (divc) with its reciprocal in the dtype.
_CONST_FIELDS = (
    "H0", "W0", "B0", "eps_y", "y_hi", "A_spread", "MU", "K", "M0",
    "exp_m1t", "M2", "M3", "M4", "FT", "s_orf", "eps_q", "coeff", "PS", "PT",
    "v1h", "v2h", "A1", "A2", "KL_1", "KL_2", "c_p1", "c_p2", "B", "KB", "G",
    "smooth_eps")
_DIVISORS = ("half", "lin_den", "two", "three", "four", "M", "T1")


@functools.lru_cache(maxsize=None)
def plant_consts(params: press.PressParams, dt: float, substeps: int,
                 dtype: torch.dtype) -> np.ndarray:
    """``PlantConsts`` of ``csrc/bodies.cuh`` for the team body, as a
    contiguous array of ``dtype``: each value rounded to the dtype as the
    body would round it (``T(x)`` of a double, to nearest), each divisor's
    reciprocal ``T(1) / T(c)`` (the dtype's correctly rounded division,
    which is the card's), and the RK4 steps ``0.5 h``, ``h`` and ``h / 6``
    with ``h = dt / substeps`` in double, as ``rk4_step`` computes them.
    Cached, so the array outlives every launch that points to it (and
    :func:`prepare` reads its address from :func:`plant_consts_at`)."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    P = press_params_c(params)
    divisors = {"half": 0.5, "lin_den": P.lin_den, "two": 2.0, "three": 3.0,
                "four": 4.0, "M": P.M, "T1": P.T1}
    values = [np_dtype(getattr(P, f)) for f in _CONST_FIELDS]
    for name in _DIVISORS:
        c = np_dtype(divisors[name])
        values += [c, np_dtype(1) / c]
    h = dt / substeps
    values += [np_dtype(0.5 * h), np_dtype(h), np_dtype(h / 6.0)]
    return np.array(values, dtype=np_dtype)


@functools.lru_cache(maxsize=None)
def plant_consts_at(params, dt, substeps, dtype) -> int:
    """The address of :func:`plant_consts`'s array, for a launch's
    arguments (K4's, and K5's rollouts at G >= 16)."""
    return plant_consts(params, dt, substeps, dtype).ctypes.data


class PlantCfgC(ctypes.Structure):
    """``fct::PlantCfg`` of ``csrc/bodies.cuh``."""

    _fields_ = [("dt", ctypes.c_double), ("substeps", ctypes.c_int),
                ("variant", ctypes.c_int), ("has_clip", ctypes.c_int),
                ("clip", ctypes.c_double * 5)]


@functools.lru_cache(maxsize=None)
def _plant_cfg_c(dt, substeps, variant, state_clip) -> PlantCfgC:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant: {variant!r}")
    clip = (0.0,) * 5 if state_clip is None else tuple(state_clip)
    if len(clip) != 5:
        raise ValueError(f"state_clip takes 5 values, got {len(clip)}")
    return PlantCfgC(dt=dt, substeps=substeps, variant=VARIANTS[variant],
                     has_clip=int(state_clip is not None),
                     clip=(ctypes.c_double * 5)(*clip))


def plant_step_torch(cfg, x_true, x_meas, u, w, v):
    """The plain version: (x_next, x_meas_next, Fd) for x_true and x_meas
    (B, 5), u (B,), w (B, 5) or None (no disturbance), v (B, 5), a number,
    or None (nothing added to the measurement).  Fd is the forging force at
    x_meas."""
    Fd = press.forging_force(x_meas[:, 0], x_meas[:, 1], cfg.params)

    def f(x, uu):
        return press.rhs(x, uu, cfg.params, cfg.variant)

    x_next = rk4_step(f, x_true, u, cfg.dt, cfg.substeps, disturbance=w)
    if cfg.state_clip is not None:
        lim = ad.constants(cfg.state_clip, x_next.dtype, x_next.device)
        x_next = ad.clip(torch.nan_to_num(x_next), -lim, lim)
    x_meas_next = press.measure(x_next, cfg.params, cfg.variant)
    if v is not None:
        x_meas_next = x_meas_next + v
    return x_next, x_meas_next, Fd


_SYMBOLS = {torch.float32: "fct_plant_f32", torch.float64: "fct_plant_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 11 + (ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p)


def check(x_true, x_meas, u, w, v, device_type: str = "cuda",
          team: int = TEAM) -> None:
    """Raise unless the inputs are what the kernel takes: tensors on one
    ``device_type`` device of one dtype (float32 or float64), x_true and
    x_meas (B, 5), u (B,), w and v (B, 5) or None, contiguous, none
    requiring a gradient; ``team`` one of :data:`TEAMS`."""
    if team not in TEAMS:
        raise ValueError(f"plant_step_cuda: team must be one of {TEAMS}, "
                         f"got {team}")
    named = {"x_true": x_true, "x_meas": x_meas, "u": u, "w": w, "v": v}
    given = {k: a for k, a in named.items() if a is not None}
    for k, a in given.items():
        if not isinstance(a, torch.Tensor):
            raise TypeError(f"plant_step_cuda: {k} must be a tensor, got "
                            f"{type(a).__name__}")
    if x_true.device.type != device_type or any(
            a.device != x_true.device for a in given.values()):
        raise ValueError(f"plant_step_cuda needs {device_type} tensors on "
                         f"one device, got "
                         f"{[str(a.device) for a in given.values()]}")
    if x_true.dtype not in _SYMBOLS or any(a.dtype != x_true.dtype
                                           for a in given.values()):
        raise TypeError(f"plant_step_cuda takes float32 or float64 of one "
                        f"dtype, got {[a.dtype for a in given.values()]}")
    B = x_true.shape[0]
    want = {"x_true": (B, 5), "x_meas": (B, 5), "u": (B,), "w": (B, 5),
            "v": (B, 5)}
    for k, a in given.items():
        if tuple(a.shape) != want[k]:
            raise ValueError(f"plant_step_cuda: {k} has shape "
                             f"{tuple(a.shape)}, expected {want[k]}")
        if not a.is_contiguous():
            raise ValueError(f"plant_step_cuda takes contiguous tensors "
                             f"({k} is not)")
        if a.requires_grad:
            raise RuntimeError("plant_step_cuda has no backward; pass "
                               "tensors that do not require a gradient")


def prepare(cfg, x_true, x_meas, u, w, v, team: int = TEAM):
    """The outputs (x_next, x_meas_next, Fd), allocated, and the C
    arguments of one launch by teams of ``team`` lanes, without the
    stream."""
    B = x_true.shape[0]
    x_next = torch.empty_like(x_true)
    x_meas_next = torch.empty_like(x_true)
    Fd = torch.empty(B, dtype=x_true.dtype, device=x_true.device)
    P = press_params_c(cfg.params)
    C = _plant_cfg_c(float(cfg.dt), int(cfg.substeps), cfg.variant,
                     None if cfg.state_clip is None
                     else tuple(float(s) for s in cfg.state_clip))
    K = plant_consts_at(cfg.params, float(cfg.dt), int(cfg.substeps),
                         x_true.dtype)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    args = (ctypes.addressof(P), ctypes.addressof(C), K,
            x_true.data_ptr(), x_meas.data_ptr(), u.data_ptr(), ptr(w),
            ptr(v), x_next.data_ptr(), x_meas_next.data_ptr(),
            Fd.data_ptr(), B, team)
    return (x_next, x_meas_next, Fd), args


def plant_step_cuda(cfg, x_true, x_meas, u, w, v, team: int = TEAM):
    """Kernel K4: (x_next, x_meas_next, Fd) as :func:`plant_step_torch`
    computes them, for contiguous CUDA tensors of one dtype that do not
    require a gradient (see :func:`check`), by teams of ``team`` lanes a
    scenario (1: one thread through the reference body)."""
    check(x_true, x_meas, u, w, v, team=team)
    if cfg.substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {cfg.substeps}")
    fn = build.entry("plant", _SYMBOLS[x_true.dtype], _ARGTYPES)
    outs, args = prepare(cfg, x_true, x_meas, u, w, v, team)
    build.launch("plant", fn, x_true.device, *args)
    return outs


def sqrt_cuda(x):
    """The kernel body's float32 square root (``csrc/bodies.cuh``
    ``sqrt_rn``, sqrtf's bits without its branch) of a contiguous float32
    CUDA tensor: what the card's check holds against ``torch.sqrt``."""
    if not (isinstance(x, torch.Tensor) and x.is_cuda
            and x.dtype == torch.float32 and x.is_contiguous()):
        raise ValueError("sqrt_cuda takes a contiguous float32 CUDA tensor")
    out = torch.empty_like(x)
    fn = build.entry("plant", "fct_plant_sqrt_f32",
                     (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                      ctypes.c_void_p))
    build.launch("plant sqrt", fn, x.device, x.data_ptr(), out.data_ptr(),
                 x.numel())
    return out


def _records(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad for a in tensors)


def plant_step(cfg, x_true, x_meas, u, w, v):
    """One control period of the plant on the tensors' device: kernel K4 on
    a card, the plain version on the CPU and wherever autograd records
    through the step (``torch.is_grad_enabled()`` and an input that
    requires a gradient).  Returns (x_next, x_meas_next, Fd)."""
    if not build.on_card(x_true.device) or _records(x_true, x_meas, u, w, v):
        return plant_step_torch(cfg, x_true, x_meas, u, w, v)
    # Autograd does not record here: the kernel takes detached views.
    c = lambda a: a.detach().contiguous() \
        if isinstance(a, torch.Tensor) else a  # noqa: E731
    return plant_step_cuda(cfg, c(x_true), c(x_meas), c(u), c(w), c(v))
