"""Batched closed-loop simulation engine.

Port of the explicit-batch engine of ``forging_control_tpu/loop/
closed_loop.py`` (``_run_batch_fused``): per control period, the controller
solves for the whole batch, the plant takes one RK4 step of ``press.rhs``
with additive process noise, and the telemetry records the measured state,
command, reference, forging force, noise and solver diagnostics.  The
``lax.scan`` over time is a Python loop here; on a card each of its periods
after the first is one replay of a CUDA graph of the period (:mod:`.graph`),
the counterpart of the scan body that XLA compiles once.

On a card the plant's side of a period is one launch of kernel K4
(:mod:`..ops.plant`) and the AL-iLQR controller's solve one launch of
kernel K5 (:mod:`..ops.ilqr`), so a captured AL-iLQR period is a few
launches; a loop that autograd records through (plant-in-loop training)
keeps the plain plant.

Every controller steps the whole batch (``step_batch``); the port has no
per-scenario vmap path.  Noise comes from an explicit ``torch.Generator``,
or pre-drawn arrays passed in (the JAX loop's per-step ``jax.random.split``
cannot be reproduced in torch, so parity runs feed the JAX run's recorded
``Telemetry.w``).

The single-stream side (``closed_loop.py:288-505`` of the JAX package):
:func:`make_stepper` (one control period per call at B = 1; on a card one
graph replay with a donated carry),
:func:`stepper_latency` and :func:`controller_latency_metrics` (per-step
wall-clock latencies in the reference's table columns), and
:func:`native_mpc_latency` (the native C++ GN-SQP of ``runtime/`` timed
step by step against the port's float64 RK4 plant on the CPU).
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import dual as ad
from ..device import resolve_device
from ..ops import plant
from ..physics import press
from ..solver import riccati, sqp
from ..utils.profiling import annotate
from . import graph as graph_mod


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    """Closed-loop settings (cf. ``Generate Data/Main.py:45-58``); the same
    fields and defaults as the JAX package's ``LoopConfig``."""

    t_steps: int = 300
    dt: float = 1e-3
    substeps: int = 4
    variant: press.Variant = "smooth"   # plant + measurement variant
    process_std: tuple = (0.0,) * 5     # per-state process noise std
    meas_std: tuple = (0.0,) * 5        # per-state measurement noise std
    params: press.PressParams = press.DEFAULT_PARAMS
    # Optional per-state |x| clamp after each integration step (policy
    # training in the loop); None = faithful plant.
    state_clip: tuple | None = None


class Telemetry(NamedTuple):
    """Per-step record with (B, T, ...) leaves: measured state after each
    step, command, reference, forging force at the pre-step measured
    state, process noise, and stacked solver diagnostics."""

    x: torch.Tensor      # (B, T, 5)
    u: torch.Tensor      # (B, T)
    ref: torch.Tensor    # (B, T)
    Fd: torch.Tensor     # (B, T)
    w: torch.Tensor      # (B, T, 5)
    diag: sqp.Diagnostics


def resolve_backend(backend: str, horizon: int) -> str:
    """Resolve backend="auto": the condensed GN-SQP at N <= 12, the AL-iLQR
    Riccati backend above (the JAX package's measured split)."""
    if backend != "auto":
        return backend
    return "sqp" if horizon <= 12 else "ilqr"


@dataclasses.dataclass(frozen=True)
class MPCController:
    """MPC with shift warm start over the whole batch.

    ``backend``: "sqp" (condensed GN-SQP), "ilqr" (Riccati sweep) or
    "auto" (:func:`resolve_backend`).  ``linsolve`` picks the kernels or
    their plain reference on a card: for the SQP its Gauss-Newton
    iterations ("kernel": the build, B1 and the search,
    ``sqp.solve_batch``'s ``linsolve``), for the AL-iLQR its whole solve
    ("kernel": K5, ``riccati.solve_batch``'s ``solver``); "plain" runs the
    tensor code.  On the CPU both run the tensor code."""

    cfg: sqp.MPCConfig
    backend: str = "sqp"
    linsolve: str = "kernel"

    def __post_init__(self):
        if self.backend == "auto":
            object.__setattr__(self, "backend",
                               resolve_backend("auto", self.cfg.horizon))
        if self.backend not in ("sqp", "ilqr"):
            raise ValueError(f"unknown backend {self.backend!r}")
        if self.linsolve not in sqp.LINSOLVES:
            raise ValueError(f"unknown linsolve {self.linsolve!r}")

    def _mod(self):
        return riccati if self.backend == "ilqr" else sqp

    def init_carry_batch(self, n_batch: int, dtype, device="cuda"):
        state = self._mod().init_state(self.cfg, dtype, device)
        return type(state)(*(a.expand(n_batch, *a.shape) for a in state))

    def step_batch(self, carry, x_meas, ref, u_prev):
        mod = self._mod()
        shifted = mod.shift_state(carry)
        if self.backend == "ilqr":
            return riccati.solve_batch(self.cfg, x_meas, ref, u_prev, shifted,
                                       solver=self.linsolve)
        return sqp.solve_batch(self.cfg, x_meas, ref, u_prev, shifted,
                               linsolve=self.linsolve)


@dataclasses.dataclass(frozen=True)
class FunctionController:
    """Stateless controller from a batched function
    ``u = fn(x_meas (B, 5), ref (B,), u_prev (B,))``, e.g. a trained NN
    policy with baked-in scalers."""

    fn: Callable

    def init_carry_batch(self, n_batch: int, dtype, device="cuda"):
        return torch.zeros(n_batch, dtype=dtype,
                           device=resolve_device(device))

    def step_batch(self, carry, x_meas, ref, u_prev):
        u0 = self.fn(x_meas, ref, u_prev)
        return u0, carry, sqp.Diagnostics.zeros(x_meas.dtype, x_meas.shape[:1],
                                                x_meas.device)


def _noise(std, given, t, generator, B, dtype, device, what):
    """Additive noise of one step: the pre-drawn ``given[:, t]``, else std *
    N(0, 1) draws from ``generator`` (on its own device)."""
    if given is not None:
        return given[:, t]
    if not any(s != 0 for s in std):
        return torch.zeros(B, 5, dtype=dtype, device=device)
    if generator is None:
        raise ValueError(f"{what} noise is configured: pass a torch.Generator "
                         f"or pre-drawn noise")
    z = torch.randn(B, 5, generator=generator, dtype=dtype,
                    device=generator.device)
    return z.to(device) * ad.constants(std, dtype, device)


def draw_noise(loop_cfg: LoopConfig, generator: torch.Generator, B: int,
               dtype, device):
    """The noise that :func:`run_batch` would draw from ``generator``,
    drawn ahead: (process, measurement), each (B, T, 5) on ``device`` or
    None where its std is zero.  Per period the process draw comes before
    the measurement draw, as in the loop, so passing them to ``run_batch``
    as ``process_noise`` and ``meas_noise`` gives its own draws bitwise."""
    stds = (loop_cfg.process_std, loop_cfg.meas_std)
    draws = ([], [])
    for _ in range(loop_cfg.t_steps):
        for out, std in zip(draws, stds):
            if any(s != 0 for s in std):
                out.append(torch.randn(B, 5, generator=generator, dtype=dtype,
                                       device=generator.device))
    return tuple(torch.stack(out, dim=1).to(device)
                 * ad.constants(std, dtype, device) if out else None
                 for out, std in zip(draws, stds))


class StepperCarry(NamedTuple):
    """State of a single-stream stepper between calls (B = 1), and of
    :func:`run_batch`'s loop."""

    x_true: torch.Tensor      # (B, 5)
    x_meas: torch.Tensor      # (B, 5)
    ctrl: object              # the controller's carry
    u_prev: torch.Tensor      # (B,)


def _step(loop_cfg: LoopConfig, controller, carry, ref, w, v):
    """One control period from ``carry`` (a :class:`StepperCarry`): the
    controller's ``step_batch``, then the plant
    (``ops.plant.plant_step``: kernel K4 on a card unless autograd records
    through the step).  Returns (the next carry, the solver diagnostics,
    the forging force at the carry's measured state)."""
    u0, ctrl, diag = controller.step_batch(carry.ctrl, carry.x_meas, ref,
                                           carry.u_prev)
    u0 = u0.to(carry.x_true.dtype)
    x_next, x_meas, Fd = plant.plant_step(loop_cfg, carry.x_true,
                                          carry.x_meas, u0, w, v)
    return StepperCarry(x_next, x_meas, ctrl, u0), diag, Fd


def _period(loop_cfg: LoopConfig, controller, carry, inputs):
    """One iteration of :func:`run_batch`'s loop, the body that a CUDA
    graph captures: :func:`_step`, with the forging force at the measured
    state it starts from.  ``inputs`` = (ref (B,), w (B, 5), v (B, 5)).
    Returns (the next carry, (x_meas, u, Fd, diag))."""
    ref, w, v = inputs
    carry, diag, Fd = _step(loop_cfg, controller, carry, ref, w, v)
    return carry, (carry.x_meas, carry.u_prev, Fd, diag)


# Captured periods of run_batch, as jit caches its programs: keyed by
# (controller, loop config without t_steps, B, dtype, device), at most
# GRAPH_CACHE_SIZE of them, the least recently used dropped first (its
# graph and private memory pool freed).  A graph's pool is one period's
# intermediates: 62-94 MB for the SQP period at B = 4,096 on an H100
# (PERF.md section 5), so the cache holds well under a gigabyte there.
GRAPH_CACHE_SIZE = 4
_GRAPHS: collections.OrderedDict = collections.OrderedDict()


def cached_period(loop_cfg: LoopConfig, controller, n_batch: int, dtype,
                  device) -> graph_mod.Period | None:
    """The captured period that :func:`run_batch` keeps for these, if any
    (its ``stats`` say what capturing it cost)."""
    key = _graph_key(loop_cfg, controller, n_batch, dtype, device)
    return None if key is None else _GRAPHS.get(key)


def _graph_key(loop_cfg, controller, n_batch, dtype, device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (controller, dataclasses.replace(loop_cfg, t_steps=0), n_batch,
           dtype, device)
    try:
        hash(key)
    except TypeError:          # a controller that is not hashable
        return None
    return key


def run_batch(loop_cfg: LoopConfig, controller, x0, refs,
              generator: torch.Generator | None = None, *,
              process_noise=None, meas_noise=None, u_init: float = 0.0,
              device="cuda", graph: bool | None = None):
    """Scenario-batched closed loop over ``loop_cfg.t_steps`` periods.

    Step semantics (``Generate Data/Functions.py:332-372``):
      u_t          = controller(x_meas_t)            (x_meas_0 = h(x0))
      x_{t+1}      = RK4 of f(x, u_t) + w_t from the true state
      x_meas_{t+1} = h(x_{t+1}) + v_t

    Args:
      x0: (B, 5) initial states; refs: (B, T) references.  Arrays or
        tensors; they are moved to ``device``, and x0's dtype (float32 or
        float64) sets the loop's.
      generator: draws w_t ~ N(0, process_std) and v_t ~ N(0, meas_std)
        when those are nonzero and no pre-drawn noise is given.
      process_noise, meas_noise: optional pre-drawn (B, T, 5) additive
        noise (already scaled); they replace the draws, and
        ``Telemetry.w`` records ``process_noise``.
      device: where the loop runs; ``"cuda"`` unless the caller asks for
        the CPU.
      graph: on a card, each period is one replay of a CUDA graph of
        :func:`_period` (:mod:`.graph`): the first period runs eagerly and
        the body is captured from its state, or a graph cached for this
        controller, loop config, B, dtype and device replays every period.
        Per period, outside the graph, the reference is copied in and the
        noise drawn from ``generator`` in the eager loop's order (or the
        pre-drawn slices copied in), so the telemetry equals the eager
        loop's.  None (the default) captures when the device is CUDA and
        autograd does not record through the period (plant-in-loop
        training backpropagates through this loop, which then stays
        eager); False runs every period eagerly, the path that the
        replay is held against; True captures or raises.  A capture or
        replay failure raises: nothing falls back to the eager loop.

    Returns (final true state (B, 5), Telemetry with (B, T, ...) leaves).
    """
    device = resolve_device(device)
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    x0 = torch.as_tensor(x0, device=device)
    dtype = x0.dtype
    refs = torch.as_tensor(refs, device=device).to(dtype)
    B, T = x0.shape[0], loop_cfg.t_steps
    if process_noise is not None:
        process_noise = torch.as_tensor(process_noise, device=device).to(dtype)
    if meas_noise is not None:
        meas_noise = torch.as_tensor(meas_noise, device=device).to(dtype)

    carry = StepperCarry(
        x_true=x0,
        x_meas=press.measure(x0, loop_cfg.params, loop_cfg.variant),
        ctrl=controller.init_carry_batch(B, dtype, device),
        u_prev=torch.full((B,), u_init, dtype=dtype, device=device))
    ws = []

    def inputs(t):
        w = _noise(loop_cfg.process_std, process_noise, t, generator, B,
                   dtype, device, "process")
        v = _noise(loop_cfg.meas_std, meas_noise, t, generator, B, dtype,
                   device, "measurement")
        ws.append(w)
        return refs[:, t], w, v

    if device.type != "cuda":
        graph = False
    key = None if graph is False else _graph_key(loop_cfg, controller, B,
                                                 dtype, device)
    period = None if key is None else _GRAPHS.get(key)
    if period is not None:
        _GRAPHS.move_to_end(key)
    carry, outs, captured = graph_mod.run(
        functools.partial(_period, loop_cfg, controller), carry, inputs, T,
        graph=graph, period=period)
    if captured is not None and captured is not period and key is not None:
        _GRAPHS[key] = captured
        while len(_GRAPHS) > GRAPH_CACHE_SIZE:
            _GRAPHS.popitem(last=False)

    stack = lambda xs: torch.stack(xs, dim=1)  # noqa: E731
    xs, us, Fds, diags = zip(*outs)
    diag = sqp.Diagnostics(*(
        None if vals[0] is None else stack(list(vals))
        for vals in zip(*diags)))
    return carry.x_true, Telemetry(
        x=stack(list(xs)), u=stack(list(us)),
        ref=stack([refs[:, t] for t in range(T)]), Fd=stack(list(Fds)),
        w=stack(ws), diag=diag)


class _GraphStepper:
    """The card's stepper: one replay of a CUDA graph of :func:`_period`
    at B = 1 per call.  The graph is the one :func:`run_batch` cached for
    this controller and loop config at B = 1, which the stepper then takes
    for its own; else the first call runs one period eagerly and captures
    the graph from the state it left.  A call writes the reference (and
    any given noise) into the static inputs and replays once.  The carry it
    returns holds the static buffers themselves, as a donated JAX carry
    does: the next call overwrites them, so a carry that an earlier call
    consumed raises.

    Spans (``utils.profiling``): a call is ``stepper``, and the writes of
    its inputs before the replay ``stepper.inputs``, both profiler ranges
    only; the first call's eager period and capture are the kept
    ``period.first``."""

    def __init__(self, loop_cfg, controller, carry0, noise, dtype, device):
        self.loop_cfg, self.noise = loop_cfg, noise
        self.dtype, self.device = dtype, device
        self.body = functools.partial(_period, loop_cfg, controller)
        self.live = carry0
        key = _graph_key(loop_cfg, controller, 1, dtype, device)
        self.period = None if key is None else _GRAPHS.pop(key, None)
        if self.period is not None:
            graph_mod.copy_into(self.period.state, carry0)

    def __call__(self, carry, ref, process_noise=None, meas_noise=None):
        with annotate("stepper"):
            if carry is not self.live:
                raise RuntimeError(
                    "this stepper carry was consumed by an earlier step (the "
                    "card's stepper donates it: its buffers now hold a later "
                    "state); pass the carry that the last step returned")
            if self.period is None:
                u = self._first(carry, ref, process_noise, meas_noise)
            else:
                with annotate("stepper.inputs"):
                    static_ref, static_w, static_v = self.period.inputs
                    static_w.copy_(self.noise(self.loop_cfg.process_std,
                                              process_noise, "process"))
                    static_v.copy_(self.noise(self.loop_cfg.meas_std,
                                              meas_noise, "measurement"))
                    if isinstance(ref, torch.Tensor):
                        static_ref.copy_(ref.reshape(1))
                    else:
                        static_ref.fill_(float(ref))
                u = self.period()[1].clone()
            self.live = StepperCarry(*self.period.state)
        return self.live, u[0]

    def _first(self, carry, ref, process_noise, meas_noise):
        """The first call: one eager period, then its capture."""
        with annotate("period.first"):
            with annotate("period.eager"):
                w = self.noise(self.loop_cfg.process_std, process_noise,
                               "process")
                v = self.noise(self.loop_cfg.meas_std, meas_noise,
                               "measurement")
                ref = torch.as_tensor(ref, device=self.device).to(
                    self.dtype).reshape(1)
                state, inputs = graph_mod.tree_map(
                    lambda a: a.contiguous(), (carry, (ref, w, v)))
                state, (_, u, _, _) = self.body(state, inputs)
            self.period = graph_mod.Period(self.body, state, inputs)
            self.period.capture()
        return u


def make_stepper(loop_cfg: LoopConfig, controller, x0=None,
                 generator: torch.Generator | None = None,
                 u_init: float = 0.0, dtype=torch.float32, device="cuda"):
    """Single-stream deployment stepper: ONE control period per call.

    The reference's ``make_step`` pair (``controller.make_step`` +
    ``simulator.make_step``, ``Generate Data/Functions.py:335-349``): the
    controller's ``step_batch`` at B = 1, then one plant period, exactly one
    iteration of :func:`run_batch`'s loop.  The carry stays on ``device``
    between calls.  On a card the period is a CUDA graph replayed once per
    call, and the carry is donated (:class:`_GraphStepper`), the
    counterpart of the JAX package's ahead-of-time stepper with
    ``donate_argnums=0``; on the CPU every call runs the period eagerly.

    Returns ``(step, carry0)``; ``step(carry, ref, process_noise=None,
    meas_noise=None) -> (carry, u)`` with u a 0-d tensor on ``device``.
    Noise given to ``step`` (5 values, already scaled) replaces the draws;
    otherwise configured noise is drawn from ``generator``.
    """
    device = resolve_device(device)
    x0 = torch.as_tensor(press.X0_REFERENCE if x0 is None else x0,
                         dtype=dtype, device=device).reshape(1, 5)
    carry0 = StepperCarry(
        x_true=x0,
        x_meas=press.measure(x0, loop_cfg.params, loop_cfg.variant),
        ctrl=controller.init_carry_batch(1, dtype, device),
        u_prev=torch.full((1,), u_init, dtype=dtype, device=device))

    def noise(std, given, what):
        if given is not None:
            return torch.as_tensor(given, device=device).to(dtype).reshape(
                1, 5)
        return _noise(std, None, 0, generator, 1, dtype, device, what)

    if device.type == "cuda":
        return _GraphStepper(loop_cfg, controller, carry0, noise, dtype,
                             device), carry0

    def step(carry: StepperCarry, ref, process_noise=None, meas_noise=None):
        with annotate("stepper"):
            with annotate("stepper.inputs"):
                ref = torch.as_tensor(ref, device=device).to(dtype).reshape(
                    1)
                w = noise(loop_cfg.process_std, process_noise, "process")
                v = noise(loop_cfg.meas_std, meas_noise, "measurement")
            carry, _, _ = _step(loop_cfg, controller, carry, ref, w, v)
        return carry, carry.u_prev[0]

    return step, carry0


def stepper_latency(loop_cfg: LoopConfig, controller, refs, *,
                    dtype=torch.float32, x0=None,
                    generator: torch.Generator | None = None, device="cuda"):
    """Per-step wall-clock latencies (seconds) of :func:`make_stepper` over
    the reference stream ``refs`` (T,) on ``device``.

    Each step is timed by ``perf_counter`` around the call and the read of
    the command to the host (``float(u)``, which waits for the device), the
    reference's ``do_mpc.tools.Timer`` semantics around ``make_step``
    (``Generate Data/Functions.py:335-337``); on a card a step is the
    writes of its inputs and one graph replay.  The first step is the
    warm-up (on a card, the eager period and the capture, unless
    :func:`run_batch` left a graph at B = 1) and is excluded, so the result
    has ``len(refs) - 1`` entries and the trajectory follows ``refs`` once.
    Configured noise is drawn from ``generator``, by default one seeded
    with 0.
    """
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    step, carry = make_stepper(loop_cfg, controller, x0=x0,
                               generator=generator, dtype=dtype,
                               device=device)
    if isinstance(refs, torch.Tensor):
        refs = refs.detach().cpu().numpy()
    refs = torch.as_tensor(np.asarray(refs, np.float64).ravel(),
                           device=device).to(dtype)
    carry, u = step(carry, refs[0])            # warm-up step
    float(u)
    times = np.empty(len(refs) - 1)
    for t in range(1, len(refs)):
        t1 = time.perf_counter()
        carry, u = step(carry, refs[t])
        float(u)
        times[t - 1] = time.perf_counter() - t1
    return times


def controller_latency_metrics(loop_cfg: LoopConfig, controller, refs, *,
                               dtype=torch.float32, device="cuda") -> dict:
    """Reference-format latency columns (ms), measured on the controller.

    Mean/Std/Median/25_perc/75_perc come from the single-stream stepper on
    the CPU (``device="cpu"``): sequential per-step wall clock of the
    controller and plant, comparable with the reference's workstation-CPU
    rows.  When ``device`` is a card, the mean of the same stepper there is
    added under the JAX package's key ``Tunnel_time``, so the tables keep
    their schema.  On an H100 that key holds the card stepper's per-step
    time: one replay of the period's CUDA graph and the read of the command
    back, the counterpart of the JAX package's ahead-of-time stepper, not a
    transport to a remote device as on the JAX package's TPU host.
    """
    from ..eval import metrics

    out = metrics.latency_stats(stepper_latency(
        loop_cfg, controller, refs, dtype=dtype, device="cpu"))
    if resolve_device(device).type == "cuda":
        t_dev = stepper_latency(loop_cfg, controller, refs, dtype=dtype,
                                device=device)
        out["Tunnel_time"] = float(t_dev.mean() * 1e3)
    return out


def native_mpc_latency(loop_cfg: LoopConfig, mpc_cfg, refs, *,
                       seed: int = 0):
    """Per-step wall-clock latencies (s) of the native C++ GN-SQP MPC.

    The hard-real-time MPC path (``runtime/src/sqp_solver.h``) driven
    through the chain's evaluation protocol: per control period the
    warm-started native solve is timed, then the plant advances one period
    untimed, the port's float64 RK4 on the CPU with the loop config's
    process and measurement noise from ``np.random.default_rng(seed)`` (as
    in the JAX package).  The native solver takes its iteration structure
    (horizon, GN x AL counts, pressure bounds, AL penalties) from
    ``mpc_cfg``.

    Returns (x_meas (T, 5), u (T,), times_s (T - 1,)); the first, cold
    solve is excluded from the latencies, as in :func:`stepper_latency`.
    Raises ``runtime.NativeBuildError`` when the runtime cannot be built.
    """
    from .. import runtime

    mpc = runtime.NativeMPC(
        horizon=mpc_cfg.horizon, dt=mpc_cfg.dt, substeps=mpc_cfg.substeps,
        gn_iters=mpc_cfg.gn_iters, al_iters=mpc_cfg.al_iters,
        p_max=mpc_cfg.p_max, p_min=mpc_cfg.p_min, mu0=mpc_cfg.mu0,
        mu_factor=mpc_cfg.mu_factor)
    if isinstance(refs, torch.Tensor):
        refs = refs.detach().cpu().numpy()
    refs = np.asarray(refs, np.float64).ravel()
    rng = np.random.default_rng(seed)
    p_std = np.asarray(loop_cfg.process_std, np.float64)
    m_std = np.asarray(loop_cfg.meas_std, np.float64)

    x = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).reshape(1, 5)
    x_meas = press.measure(x, loop_cfg.params, loop_cfg.variant)[0].numpy()
    u_prev = 0.0
    T = len(refs)
    xs, us, times = np.empty((T, 5)), np.empty(T), np.empty(T - 1)
    for t in range(T):
        t0 = time.perf_counter()
        u, _stats = mpc.step(x_meas, refs[t], u_prev)
        dt_s = time.perf_counter() - t0
        if t > 0:
            times[t - 1] = dt_s
        w = rng.normal(size=5) * p_std
        v = rng.normal(size=5) * m_std
        x, x_meas_t, _ = plant.plant_step_torch(
            loop_cfg, x, x, torch.tensor([u], dtype=torch.float64),
            torch.from_numpy(w)[None], None)
        x_meas = x_meas_t[0].numpy() + v
        xs[t] = x_meas
        us[t] = u
        u_prev = u
    return xs, us, times


def default_x0(dtype=torch.float64, device="cuda") -> torch.Tensor:
    """The reference's initial state ``press.X0_REFERENCE`` (5,)."""
    return torch.tensor(press.X0_REFERENCE, dtype=dtype,
                        device=resolve_device(device))
