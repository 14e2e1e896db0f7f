"""The captured control period on the CPU (float64): what a CUDA graph of
one period needs and what it must reproduce.

A card captures ``loop.closed_loop._period`` (one iteration of
``run_batch``'s loop) over static buffers (``loop.graph.Period``) and
replays it; the stepper captures ``_step`` at B = 1.  The capture needs a
period that makes no tensor from host data (a copy from pageable memory,
an error inside a capture), reads no scalar back and calls no ``nonzero``
(both synchronise).  The replay must equal the eager loop: here the same
body runs uncaptured on the static buffers (``Period.capture`` is the one
step that needs a card, and is left out), held bitwise against the eager
``run_batch`` and, for the stepper, against the JAX package's donated
ahead-of-time stepper.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_host_kernels as hk
from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.loop import graph
from forging_control_tpu_torch.nn import fnn
from forging_control_tpu_torch.ops import plant
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import feasibility as feas
from forging_control_tpu_torch.solver import sqp

N = 3
F64 = torch.float64
SYNCING = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")


class _Scaler:
    def __init__(self, shift, scale):
        self.shift = torch.tensor(shift, dtype=F64)
        self.scale = torch.tensor(scale, dtype=F64)


def _fnn_policy():
    params, _ = fnn.init(torch.Generator().manual_seed(0), dtype=F64,
                         device="cpu")
    return fnn.make_policy(params, _Scaler([0.0, 0.0, 0.3], [0.5, 0.5, 0.3]),
                           _Scaler([0.0], [0.2]))


def _controllers():
    fast = sqp.MPCConfig.fast(horizon=N, gn_iters=5, variant="smooth")
    return {
        "sqp_fast_5x1": cl.MPCController(fast, linsolve="plain"),
        "sqp_teacher_6x2": cl.MPCController(sqp.MPCConfig(
            horizon=N, gn_iters=6, al_iters=2, p_max=32e6,
            variant="smooth")),
        "ilqr": cl.MPCController(fast, backend="ilqr"),
        "fnn": cl.FunctionController(_fnn_policy()),
        "recovering": feas.RecoveringController(_fnn_policy()),
    }


class _SyncCounter(TorchDispatchMode):
    """Counts the ops that make a tensor from host data or synchronise."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(SYNCING):
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


def _start(ctrl, B, dtype=F64, loop_cfg=None):
    loop_cfg = loop_cfg or cl.LoopConfig(variant="smooth")
    x0 = torch.tensor(press.X0_REFERENCE, dtype=dtype).repeat(B, 1)
    x0[:, 1] = torch.linspace(0.0, 0.2, B, dtype=dtype)
    return cl.StepperCarry(
        x_true=x0, x_meas=press.measure(x0, loop_cfg.params, loop_cfg.variant),
        ctrl=ctrl.init_carry_batch(B, dtype, "cpu"),
        u_prev=torch.zeros(B, dtype=dtype))


@pytest.mark.parametrize("kind", ["sqp_fast_5x1", "sqp_teacher_6x2", "ilqr",
                                  "fnn", "recovering", "plant"])
def test_torch_period_makes_no_host_tensor_and_never_syncs(kind):
    """One control period, after a warm-up period, under a dispatch mode:
    no aten.lift_fresh (a tensor from host data), no _local_scalar_dense
    (a scalar read back) and no nonzero, in float32 as on the card.  The
    plant period runs with the state clip of plant-in-loop training."""
    B, f32 = 4, torch.float32
    ref = torch.full((B,), 0.3)
    w = torch.full((B, 5), 1e-3)
    if kind == "plant":
        loop_cfg = cl.LoopConfig(variant="smooth",
                                 state_clip=(1.0, 10.0, 1e9, 1e9, 1.0))
        x = _start(cl.FunctionController(None), B, f32, loop_cfg).x_true

        def period():
            return plant.plant_step(loop_cfg, x, x, ref, w, w)
    else:
        loop_cfg = cl.LoopConfig(variant="smooth")
        ctrl = _controllers()[kind]
        carry = _start(ctrl, B, f32, loop_cfg)
        body = functools.partial(cl._period, loop_cfg, ctrl)

        def period():
            return body(carry, (ref, w, w))
    period()                                  # warm-up (weight caches)
    counter = _SyncCounter()
    with counter:
        period()
    assert dict(counter.found) == {}


@pytest.mark.parametrize("kind", ["ilqr", "fnn", "plant"])
def test_torch_kernel_period_makes_no_host_tensor_and_never_syncs(
        kind, monkeypatch):
    """The check above with the dispatch taking the kernels, as on a card:
    the AL-iLQR solve through K5 and every plant step through K4 (their
    bodies run on the CPU from the host library, through the wrappers'
    own checks, allocations and argument packing).  No host-data tensor,
    no scalar read, no nonzero; one launch of each kernel a period."""
    counts = hk.route_kernels_to_host(monkeypatch)
    B, f32 = 4, torch.float32
    ref = torch.full((B,), 0.3)
    w = torch.full((B, 5), 1e-3)
    if kind == "plant":
        loop_cfg = cl.LoopConfig(variant="smooth",
                                 state_clip=(1.0, 10.0, 1e9, 1e9, 1.0))
        x = _start(cl.FunctionController(None), B, f32, loop_cfg).x_true

        def period():
            return plant.plant_step(loop_cfg, x, x, ref, w, w)
    else:
        loop_cfg = cl.LoopConfig(variant="smooth")
        ctrl = _controllers()[kind]
        carry = _start(ctrl, B, f32, loop_cfg)
        body = functools.partial(cl._period, loop_cfg, ctrl)

        def period():
            return body(carry, (ref, w, w))
    period()                                  # warm-up (weight caches)
    counter = _SyncCounter()
    with counter:
        period()
    assert dict(counter.found) == {}
    assert dict(counts) == ({"plant": 2, "ilqr": 2} if kind == "ilqr"
                            else {"plant": 2})


def test_torch_kernel_static_period_equals_eager_run_batch(monkeypatch):
    """The AL-iLQR period through both kernels (bodies on the CPU), called
    on its static buffers, equals the eager run_batch through them bitwise;
    each kernel launched once a period in either."""
    counts = hk.route_kernels_to_host(monkeypatch)
    (x_e, tel_e), (x_s, xs, us, Fds) = _eager_and_static("ilqr", "pre-drawn")
    assert dict(counts) == {"plant": 10, "ilqr": 10}
    assert torch.equal(us, tel_e.u) and torch.equal(xs, tel_e.x)
    assert torch.equal(Fds, tel_e.Fd) and torch.equal(x_s, x_e)


def _eager_and_static(kind, noise, T=5, B=3):
    """(eager run_batch, the static-buffer period T times) on one input:
    each telemetry and the final state."""
    loop_cfg = cl.LoopConfig(t_steps=T, variant="smooth",
                             process_std=(5e-4, 2e-3, 5e4, 5e4, 2e-3),
                             meas_std=(1e-5, 1e-4, 1e4, 1e4, 1e-4))
    ctrl = _controllers()[kind]
    rng = np.random.RandomState(3)
    refs = torch.from_numpy(rng.uniform(0.05, 0.5, (B, T)))
    pre = {}
    if noise == "pre-drawn":
        pre = {"process_noise": torch.from_numpy(
                   rng.randn(B, T, 5) * loop_cfg.process_std),
               "meas_noise": torch.from_numpy(
                   rng.randn(B, T, 5) * loop_cfg.meas_std)}
    start = _start(ctrl, B, F64, loop_cfg)
    x_e, tel_e = cl.run_batch(loop_cfg, ctrl, start.x_true, refs,
                              torch.Generator().manual_seed(7), device="cpu",
                              **pre)

    gen = torch.Generator().manual_seed(7)

    def inputs(t):
        return tuple(
            pre[k][:, t] if k in pre else cl._noise(
                std, None, t, gen, B, F64, torch.device("cpu"), k)
            for k, std in (("process_noise", loop_cfg.process_std),
                           ("meas_noise", loop_cfg.meas_std)))

    zero = torch.zeros(B, 5, dtype=F64)
    period = graph.Period(functools.partial(cl._period, loop_cfg, ctrl),
                          start, (refs[:, 0], zero, zero))
    outs = []
    for t in range(T):
        graph.copy_into(period.inputs, (refs[:, t], *inputs(t)))
        outs.append(graph.tree_map(torch.clone, period()))
    xs, us, Fds, _ = zip(*outs)
    return (x_e, tel_e), (period.state.x_true, torch.stack(xs, 1),
                          torch.stack(us, 1), torch.stack(Fds, 1))


@pytest.mark.parametrize("noise", ["pre-drawn", "generator"])
@pytest.mark.parametrize("kind", ["sqp_fast_5x1", "recovering", "fnn"])
def test_torch_static_period_equals_eager_run_batch(kind, noise):
    """The body that a card captures, called directly on its static
    buffers for T = 5 periods, equals the eager run_batch bitwise: the
    commands, the measured states, the forging force and the final true
    state; with pre-drawn noise and with the generator's draws, taken
    outside the period in the eager loop's order."""
    (x_e, tel_e), (x_s, xs, us, Fds) = _eager_and_static(kind, noise)
    assert torch.equal(us, tel_e.u)
    assert torch.equal(xs, tel_e.x)
    assert torch.equal(Fds, tel_e.Fd)
    assert torch.equal(x_s, x_e)
    assert bool(torch.all(tel_e.w[..., 2] != 0))


@pytest.fixture
def uncaptured(monkeypatch):
    """``Period.capture`` as a no-op: on the CPU every call of a period
    then runs its body eagerly on the static buffers."""
    monkeypatch.setattr(graph.Period, "capture", lambda self: None)


def test_torch_graph_run_cached_period_equals_eager(uncaptured):
    """loop.graph.run as run_batch drives it on a card: the first period
    eager, the rest through the period made from its state; then a second
    run through that (cached) period from the start.  Both equal the
    eager loop bitwise."""
    T, B = 5, 3
    ctrl = _controllers()["sqp_fast_5x1"]
    loop_cfg = cl.LoopConfig(t_steps=T, variant="smooth")
    refs = torch.linspace(0.05, 0.45, B * T, dtype=F64).reshape(B, T)
    start = _start(ctrl, B)
    x_e, tel_e = cl.run_batch(loop_cfg, ctrl, start.x_true, refs,
                              device="cpu")
    body = functools.partial(cl._period, loop_cfg, ctrl)
    zero = torch.zeros(B, 5, dtype=F64)

    def inputs(t):
        return refs[:, t], zero, zero

    period = None
    for _ in range(2):
        state, outs, period = graph.run(body, start, inputs, T, graph=True,
                                        period=period)
        assert isinstance(period, graph.Period)
        assert torch.equal(torch.stack([o[1] for o in outs], 1), tel_e.u)
        assert torch.equal(state.x_true, x_e)


def test_torch_graph_run_leaves_a_recording_loop_eager(uncaptured):
    """A period that autograd records through (plant-in-loop training)
    stays eager under graph=None, with the eager loop's values and
    gradient path, and is refused under graph=True."""
    T, B = 3, 2
    params, _ = fnn.init(torch.Generator().manual_seed(1), dtype=F64,
                         device="cpu")
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ctrl = cl.FunctionController(fnn.make_policy(
        p, _Scaler([0.0, 0.0, 0.3], [0.5, 0.5, 0.3]), _Scaler([0.0], [0.2]),
        cache=False))
    loop_cfg = cl.LoopConfig(t_steps=T, variant="smooth")
    refs = torch.full((B, T), 0.3, dtype=F64)
    body = functools.partial(cl._period, loop_cfg, ctrl)
    zero = torch.zeros(B, 5, dtype=F64)

    def inputs(t):
        return refs[:, t], zero, zero

    state, outs, period = graph.run(body, _start(ctrl, B), inputs, T,
                                    graph=None)
    assert period is None and state.x_true.requires_grad
    _, tel = cl.run_batch(loop_cfg, ctrl, _start(ctrl, B).x_true, refs,
                          device="cpu")
    assert torch.equal(torch.stack([o[1] for o in outs], 1), tel.u)
    with pytest.raises(RuntimeError, match="autograd records"):
        graph.run(body, _start(ctrl, B), inputs, T, graph=True)


def test_torch_run_batch_graph_needs_a_card():
    ctrl = _controllers()["fnn"]
    x0 = _start(ctrl, 2).x_true
    with pytest.raises(ValueError, match="CUDA"):
        cl.run_batch(cl.LoopConfig(t_steps=1), ctrl, x0,
                     torch.zeros(2, 1, dtype=F64), device="cpu", graph=True)


def test_torch_graph_cache_key():
    """One cached graph serves every run length of a controller, loop
    config, batch, dtype and device; an unhashable controller gets none."""
    ctrl = _controllers()["sqp_fast_5x1"]
    key = functools.partial(cl._graph_key, controller=ctrl, n_batch=4,
                            dtype=torch.float32, device="cpu")
    assert key(cl.LoopConfig(t_steps=1)) == key(cl.LoopConfig(t_steps=300))
    assert key(cl.LoopConfig()) != key(cl.LoopConfig(variant="raw"))
    assert cl._graph_key(cl.LoopConfig(), [ctrl], 4, torch.float32,
                         "cpu") is None


def _stepper(ctrl, loop_cfg):
    """The card's stepper (capture left out) on the CPU."""
    x0 = torch.tensor(press.X0_REFERENCE, dtype=F64).reshape(1, 5)
    carry0 = cl.StepperCarry(
        x0, press.measure(x0, loop_cfg.params, loop_cfg.variant),
        ctrl.init_carry_batch(1, F64, "cpu"), torch.zeros(1, dtype=F64))

    def noise(std, given, what):
        return torch.as_tensor(given, dtype=F64).reshape(1, 5)

    return cl._GraphStepper(loop_cfg, ctrl, carry0, noise, F64,
                            torch.device("cpu")), carry0


def test_torch_graph_stepper_equals_run_batch_and_donates(uncaptured):
    """The card's stepper at B = 1 over 5 steps equals run_batch's B = 1
    loop bitwise (given noise, references as numbers and as tensors); a
    carry that a step consumed raises."""
    T = 5
    ctrl = _controllers()["recovering"]
    loop_cfg = cl.LoopConfig(t_steps=T, variant="smooth")
    rng = np.random.RandomState(4)
    w = torch.from_numpy(rng.randn(1, T, 5) * (5e-4, 2e-3, 5e4, 5e4, 2e-3))
    v = torch.from_numpy(rng.randn(1, T, 5) * (1e-5, 1e-4, 1e4, 1e4, 1e-4))
    refs = torch.full((1, T), 0.3, dtype=F64)
    x_e, tel = cl.run_batch(loop_cfg, ctrl,
                            torch.tensor([press.X0_REFERENCE], dtype=F64),
                            refs, process_noise=w, meas_noise=v,
                            device="cpu")
    step, carry0 = _stepper(ctrl, loop_cfg)
    carry, us = carry0, []
    for t in range(T):
        ref = 0.3 if t % 2 else refs[0, t]
        carry, u = step(carry, ref, process_noise=w[0, t],
                        meas_noise=v[0, t])
        assert u.shape == ()
        us.append(u)
    assert torch.equal(torch.stack(us), tel.u[0])
    assert torch.equal(carry.x_true, x_e)
    assert torch.equal(carry.x_meas, tel.x[:, -1])
    with pytest.raises(RuntimeError, match="consumed"):
        step(carry0, 0.3, process_noise=w[0, 0], meas_noise=v[0, 0])
    step(carry, 0.3, process_noise=w[0, 0], meas_noise=v[0, 0])
    with pytest.raises(RuntimeError, match="consumed"):
        step(carry, 0.3, process_noise=w[0, 0], meas_noise=v[0, 0])


def test_torch_graph_stepper_matches_jax_aot_stepper(uncaptured):
    """The card's stepper (B = 1, noise-free) against the JAX package's
    ahead-of-time stepper with its donated carry, 5 steps from
    X0_REFERENCE, float64.  The JAX stepper equals the JAX package's own
    run_batch here exactly; the port's stepper equals the port's run_batch
    bitwise (the test above).  Between the packages the commands differ by
    3.6e-08 relative (3.5e-10 absolute): the cold start's damped normal
    systems (Levenberg damping 1e-8) amplify float64 rounding about 1e8
    times, more than at tests/test_torch_closed_loop.py's noisy mid-plateau
    start (rtol 1e-10).  Bound: rtol 1e-7 on the commands and the
    measured state (which differs by 4.8e-09 relative)."""
    T = 5
    jcfg = jsqp.MPCConfig(horizon=5, variant="smooth", gn_iters=3,
                          al_iters=1)
    jloop = jcl.LoopConfig(t_steps=T, variant="smooth")
    jstep, jcarry = jcl.make_stepper(jloop, jcl.MPCController(jcfg),
                                     dtype=jnp.float64)
    refs = [0.3, 0.3, 0.2, 0.2, 0.25]
    want = []
    for r in refs:
        jcarry, u = jstep(jcarry, jnp.asarray(r, jnp.float64))
        want.append(float(u))
    ctrl = cl.MPCController(sqp.MPCConfig(horizon=5, variant="smooth",
                                          gn_iters=3, al_iters=1))
    step, carry = _stepper(ctrl, cl.LoopConfig(t_steps=T, variant="smooth"))
    got = []
    for r in refs:
        carry, u = step(carry, r, process_noise=np.zeros(5),
                        meas_noise=np.zeros(5))
        got.append(u.item())
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(carry.x_meas[0].numpy(),
                               np.asarray(jax.device_get(jcarry.x_meas)),
                               rtol=1e-7)
