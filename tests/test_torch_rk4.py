"""Parity of the port's RK4 plant step with the JAX package (float64, CPU):
one control period (with and without additive process noise) and a
300-step replay from the reference initial state."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from forging_control_tpu.integrate import make_stepper as jmake_stepper
from forging_control_tpu.integrate.rk4 import rk4_step as jrk4
from forging_control_tpu.physics import press as jpress
from forging_control_tpu_torch.integrate import make_stepper
from forging_control_tpu_torch.integrate.rk4 import rk4_step
from forging_control_tpu_torch.physics import press


def _f_jax(x, u):
    return jpress.rhs(x, u, variant="smooth")


def _f_torch(x, u):
    return press.rhs(x, u, variant="smooth")


def test_torch_rk4_one_period_matches_jax():
    rng = np.random.default_rng(0)
    lo = np.array([0.0, -0.5, 1e6, 1e6, -0.2])
    hi = np.array([0.12, 0.8, 3e7, 3e7, 0.2])
    x = np.vstack([jpress.X0_REFERENCE, lo + (hi - lo) * rng.random((15, 5))])
    u = rng.uniform(-0.2, 0.2, len(x))
    w = rng.normal(size=(len(x), 5)) * np.array([5e-1, 2e0, 5e7, 5e7, 2e0])
    for dist in (None, w):
        want = np.asarray(jax.vmap(
            lambda xx, uu, ww: jrk4(_f_jax, xx, uu, 1e-3, 4,
                                    disturbance=None if dist is None else ww)
        )(jnp.asarray(x), jnp.asarray(u), jnp.asarray(w)))
        got = rk4_step(_f_torch, torch.from_numpy(x), torch.from_numpy(u),
                       1e-3, 4,
                       disturbance=None if dist is None
                       else torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_torch_rk4_300_step_replay_matches_jax():
    """Open-loop replay of a work/return input sequence over 300 steps
    through the cavitation transient; the states stay within 1e-9 relative
    (1e-3 Pa absolute on the pressures) of the JAX package's."""
    t = np.arange(300)
    us = np.where(t < 150, 0.12, -0.15) + 0.03 * np.sin(t / 7.0)

    @jax.jit
    def replay(x0, us):
        def step(x, u):
            xn = jrk4(_f_jax, x, u, 1e-3, 4)
            return xn, xn
        return jax.lax.scan(step, x0, us)[1]

    want = np.asarray(replay(jnp.asarray(jpress.X0_REFERENCE), jnp.asarray(us)))
    x = torch.tensor(press.X0_REFERENCE, dtype=torch.float64)
    got = []
    for u in torch.from_numpy(us):
        x = rk4_step(_f_torch, x, u, 1e-3, 4)
        got.append(x)
    got = torch.stack(got).numpy()
    assert np.all(np.isfinite(got))
    for k, atol in enumerate([1e-12, 1e-12, 1e-3, 1e-3, 1e-12]):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=1e-9, atol=atol)


def test_torch_make_stepper_matches_jax():
    """The bound stepper (dt 1 ms, 2 substeps) with and without process
    noise, float64, against the JAX package's."""
    rng = np.random.default_rng(5)
    lo = np.array([0.0, -0.5, 1e6, 1e6, -0.2])
    hi = np.array([0.12, 0.8, 3e7, 3e7, 0.2])
    x = lo + (hi - lo) * rng.random((8, 5))
    u = rng.uniform(-0.2, 0.2, len(x))
    w = rng.normal(size=(len(x), 5)) * np.array([5e-1, 2e0, 5e7, 5e7, 2e0])
    jstep = jmake_stepper(_f_jax, 1e-3, substeps=2)
    step = make_stepper(_f_torch, 1e-3, substeps=2)
    for dist in (None, w):
        want = np.asarray(jax.vmap(
            lambda xx, uu, ww: jstep(xx, uu, None if dist is None else ww)
        )(jnp.asarray(x), jnp.asarray(u), jnp.asarray(w)))
        got = step(torch.from_numpy(x), torch.from_numpy(u),
                   None if dist is None else torch.from_numpy(w))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
