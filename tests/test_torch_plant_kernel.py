"""Kernel K4 (the closed loop's plant step) on the CPU: its bodies
(``csrc/bodies.cuh`` on ``csrc/press_dual.cuh``, built for the host by
``g++ -O2 -ffp-contract=off``), the team body ``plant_team`` (G = 4) and
the one-thread reference ``plant_body`` (G = 1), against the
plain version (``ops.plant.plant_step_torch``) and the JAX package's plant
(the plant side of its closed-loop scan body), on seeded states with
process and measurement noise, the state clip with NaN and inf states, and
the ties of the physics: y = 0 and y_dot = 0 on the forging force's gate,
a pressure on the orifice's linear kink and one on its dp = 0 corner, z = 0
and p1 = 0.  The team body equals ``plant_body`` bit for bit in float64 and
float32; the plain version on the CPU rounds its pow, exp and log in
PyTorch's own vector routines, so the bodies agree with it to rounding
(relative 1e-12 in float64, 1e-5 in float32), as with the JAX package.

Also the dispatch (the CPU takes the plain version; a card takes the kernel
unless autograd records through the step) and the wrapper's refusals.
The card's own check of the kernel is ``tests/test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_host_kernels as hk
from forging_control_tpu.integrate import rk4 as jrk4
from forging_control_tpu.physics import press as jpress
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.ops import build, plant
from forging_control_tpu_torch.physics import press

B = 48
TEAMS = plant.TEAMS
PROCESS_STD = np.array([5e-4, 2e-3, 5e4, 5e4, 2e-3])
MEAS_STD = np.array([1e-5, 1e-4, 1e4, 1e4, 1e-4])
CLIP = (0.12, 0.6, 3.3e7, 3.3e7, 0.2)
PS, EPS_Q = press.DEFAULT_PARAMS.PS, press.DEFAULT_PARAMS.eps_q


def _inputs(seed=0):
    """(x_true, x_meas, u, w, v) as float64 arrays: random states, then the
    ties in the first rows."""
    rng = np.random.default_rng(seed)
    lo = np.array([-0.02, -0.9, -3e6, -3e6, -0.25])
    hi = np.array([0.15, 0.9, 3.5e7, 3.5e7, 0.25])
    x = lo + (hi - lo) * rng.random((B, 5))
    x[0] = press.X0_REFERENCE                      # y = y_dot = z = 0
    x[1] = (0.03, 0.0, 8e6, 4e6, 0.05)             # y > 0, y_dot = 0: gate
    x[2] = (0.03, 0.2, PS - EPS_Q / 2, 4e6, 0.05)  # on the orifice's kink
    x[3] = (0.03, 0.2, PS, 4e6, 0.05)              # dp = 0 exactly
    x[4] = (0.03, 0.2, 8e6, 4e6, 0.0)              # z = 0: the work branch
    x[5] = (0.08, 0.3, 0.0, 9e6, -0.07)            # p1 = 0: clamp's tie
    x_meas = x + rng.standard_normal((B, 5)) * MEAS_STD
    x_meas[:6] = x[:6]
    u = rng.uniform(-0.25, 0.25, B)
    w = rng.standard_normal((B, 5)) * PROCESS_STD
    v = rng.standard_normal((B, 5)) * MEAS_STD
    return x, x_meas, u, w, v


def _jax_plant(cfg, x_true, x_meas, u, w, v):
    """The JAX package's closed-loop plant side (closed_loop.py:257-276)."""
    def f(x, uu):
        return jpress.rhs(x, uu, jpress.DEFAULT_PARAMS, cfg.variant)

    Fd = jpress.forging_force(x_meas[:, 0], x_meas[:, 1])
    x_next = jrk4.rk4_step(f, x_true, u, cfg.dt, cfg.substeps,
                           disturbance=w)
    if cfg.state_clip is not None:
        lim = jnp.asarray(cfg.state_clip, x_next.dtype)
        x_next = jnp.clip(jnp.nan_to_num(x_next), -lim, lim)
    x_meas_next = jpress.measure(x_next, jpress.DEFAULT_PARAMS,
                                 cfg.variant) + v
    return tuple(np.asarray(a) for a in (x_next, x_meas_next, Fd))


def _close(got, want):
    """Rounding only: relative 1e-12 per entry (states span 1e-3 to 3e7),
    NaN where the other has NaN."""
    for g, ww in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), ww, rtol=1e-12, atol=1e-12)


def _bits(a):
    return a.view(torch.int64 if a.dtype == torch.float64 else torch.int32)


def _same_bits(got, want):
    for g, ww in zip(got, want):
        assert g.dtype == ww.dtype and torch.equal(_bits(g), _bits(ww))


@pytest.mark.parametrize("clip", [None, CLIP], ids=["faithful", "clipped"])
@pytest.mark.parametrize("variant", ["raw", "smooth", "clamp"])
def test_torch_plant_host_matches_plain_and_jax(variant, clip):
    """Both bodies (the team body and the one-thread plant_body) against
    the plain version and the JAX package, and against each other bit for
    bit."""
    cfg = cl.LoopConfig(variant=variant, state_clip=clip)
    x, x_meas, u, w, v = _inputs()
    if clip is not None:
        # Diverged states: nan_to_num maps NaN to 0 and +-inf to the
        # largest finite value before the clip.
        x[6, 2], x[7, 3], x[8, 1] = np.nan, np.inf, -np.inf
    t = hk.float64(x, x_meas, u, w, v)
    plain = [a.numpy() for a in plant.plant_step_torch(cfg, *t)]
    want = _jax_plant(cfg, *(jnp.asarray(a) for a in (x, x_meas, u, w, v)))
    body = hk.plant_host(cfg, *t, team=1)
    for team in TEAMS:
        got = hk.plant_host(cfg, *t, team=team)
        _same_bits(got, body)
        _close(got, plain)
        _close(got, want)
        if clip is not None:
            assert np.isfinite(got[0].numpy()).all()
        # The gate: no force at y = 0, a force at y > 0 with y_dot = 0.
        assert got[2][0] == 0.0 and got[2][1] > 0.0


def test_torch_plant_host_without_noise_terms_matches_plain():
    """w None (no disturbance added) and v None (nothing added to the
    measurement), as DAgger's rollout calls it; both bodies."""
    cfg = cl.LoopConfig(variant="smooth")
    x, x_meas, u, _, _ = _inputs(1)
    t = hk.float64(x, x_meas, u)
    plain = [a.numpy() for a in plant.plant_step_torch(cfg, *t, None, None)]
    body = hk.plant_host(cfg, *t, None, None, team=1)
    for team in TEAMS:
        got = hk.plant_host(cfg, *t, None, None, team=team)
        _same_bits(got, body)
        _close(got, plain)


def test_torch_plant_host_float32_near_plain():
    """float32 through the same bodies: the team body bit for bit the
    one-thread body's, both within float32 rounding of the plain version
    (relative 1e-5 on a period's states)."""
    cfg = cl.LoopConfig(variant="smooth")
    x, x_meas, u, w, v = _inputs(2)
    t = tuple(a.float() for a in hk.float64(x, x_meas, u, w, v))
    plain = plant.plant_step_torch(cfg, *t)
    body = hk.plant_host(cfg, *t, team=1)
    for team in TEAMS:
        got = hk.plant_host(cfg, *t, team=team)
        _same_bits(got, body)
        for g, p in zip(got, plain):
            assert g.dtype == torch.float32
            torch.testing.assert_close(g, p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("batch", [1, 2, B])
def test_torch_plant_team_equals_body_bitwise(batch, dtype):
    """The team body against the one-thread body, bit for bit: the three
    variants, with and without the clip, with and without the noise
    terms, at B = 1 (the single-stream stepper), 2 (the
    RecoveringController) and 48.  The first rows are the ties (the gate,
    the kink, dp = 0, z = 0, p1 = 0) and, with the clip, a NaN, an inf and
    a -inf state (rows 7 to 9, which B = 1 and 2 start from)."""
    clean = _inputs(5)
    diverged = tuple(a.copy() for a in clean)
    diverged[0][6, 2], diverged[0][7, 3] = np.nan, np.inf
    diverged[0][8, 1] = -np.inf
    for variant in ("raw", "smooth", "clamp"):
        for clip in (None, CLIP):
            cfg = cl.LoopConfig(variant=variant, state_clip=clip)
            first = 6 if clip is not None and batch < 9 else 0
            rows = slice(first, first + batch)
            t = [torch.as_tensor(a[rows], dtype=dtype).contiguous()
                 for a in (clean if clip is None else diverged)]
            for noise in (True, False):
                args = t if noise else t[:3] + [None, None]
                _same_bits(hk.plant_host(cfg, *args, team=4),
                           hk.plant_host(cfg, *args, team=1))


def test_torch_plant_dispatch_rules(monkeypatch):
    """The CPU takes the plain version; a card takes the kernel, except
    where autograd records through the step; any other device raises."""
    cfg = cl.LoopConfig(variant="smooth")
    t = hk.float64(*_inputs(3))
    launches = build.LAUNCHES.copy()
    got = plant.plant_step(cfg, *t)
    assert build.LAUNCHES == launches
    for g, p in zip(got, plant.plant_step_torch(cfg, *t)):
        assert torch.equal(g, p)
    with pytest.raises(ValueError, match="unsupported device"):
        build.on_card(torch.device("meta"))

    counts = hk.route_kernels_to_host(monkeypatch)
    plant.plant_step(cfg, *t)
    assert counts["plant"] == 1
    u = t[2].clone().requires_grad_(True)
    x_next, _, _ = plant.plant_step(cfg, t[0], t[1], u, t[3], t[4])
    assert counts["plant"] == 1 and x_next.requires_grad   # plain: records
    with torch.no_grad():
        plant.plant_step(cfg, t[0], t[1], u, t[3], t[4])
    assert counts["plant"] == 2
    # The closed loop's period goes through the same dispatch.
    ctrl = cl.FunctionController(lambda x, ref, u_prev: u_prev)
    carry = cl.StepperCarry(t[0], t[1], None, t[2])
    cl._step(cfg, ctrl, carry, t[2], t[3], t[4])
    assert counts["plant"] == 3


def test_torch_plant_wrapper_refuses_what_the_kernel_does_not_take():
    cfg = cl.LoopConfig()
    x, x_meas, u, w, v = hk.float64(*_inputs(4))
    with pytest.raises(ValueError, match="cuda tensors"):
        plant.plant_step_cuda(cfg, x, x_meas, u, w, v)
    with pytest.raises(TypeError, match="float32 or float64"):
        plant.check(x.half(), x_meas.half(), u.half(), None, None, "cpu")
    with pytest.raises(TypeError, match="float32 or float64"):
        plant.check(x, x_meas.float(), u, w, v, "cpu")
    with pytest.raises(ValueError, match="shape"):
        plant.check(x, x_meas, u[:-1], w, v, "cpu")
    with pytest.raises(ValueError, match="contiguous"):
        plant.check(x, x_meas, u, w.t().contiguous().t(), v, "cpu")
    with pytest.raises(RuntimeError, match="backward"):
        plant.check(x, x_meas, u.requires_grad_(True), w, v, "cpu")
    with pytest.raises(TypeError, match="tensor"):
        plant.check(x, x_meas, u.detach(), w, 0.0, "cpu")
    with pytest.raises(ValueError, match="team"):
        plant.check(x, x_meas, u.detach(), w, v, "cpu", team=2)
    with pytest.raises(ValueError, match="float32 CUDA"):
        plant.sqrt_cuda(torch.ones(3))
