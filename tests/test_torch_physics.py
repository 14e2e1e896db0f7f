"""Parity of the port's press physics with the JAX package (float64, CPU).

Values and forward-mode tangents of ``rhs`` (all three variants), of
``measure`` and of the force/flow helpers are held against the JAX
package on seeded random states and on the singular corners (y = 0,
p = PS, z = 0, cavitation).  Tangents come from the port's dual numbers and
from ``jax.jacfwd``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.physics import press as jpress
from forging_control_tpu.physics import scaling as jscaling
from forging_control_tpu_torch import dual
from forging_control_tpu_torch.physics import press, scaling

VARIANTS = ("raw", "smooth", "clamp")

CORNERS = [
    np.array(jpress.X0_REFERENCE),                  # y = y_dot = z = 0
    np.array([0.0, 0.0, 0.0, 0.0, 0.0]),
    np.array([1e-9, 1e-9, 1e3, 1e3, 1e-6]),
    np.array([0.05, 0.0, 3.2e7, 101325.0, 0.0]),    # p1 = PS, p2 = PT
    np.array([0.05, 0.3, 3.2e7, 3.2e7, -0.1]),      # p2 = PS, return spool
    np.array([0.1, -0.6, -2.0e6, 3.5e7, -0.05]),    # cavitated p1
    np.array([0.08, 0.3, 0.0, 9e6, 0.07]),          # p1 at the bound
    np.array([0.02, 0.5, 7.5e6, 5.3e6, 0.0]),       # z = 0
]


def _random_states(n=24, seed=0):
    rng = np.random.default_rng(seed)
    lo = np.array([-0.02, -0.9, -3e6, -3e6, -0.25])
    hi = np.array([0.15, 0.9, 3.5e7, 3.5e7, 0.25])
    x = lo + (hi - lo) * rng.random((n, 5))
    u = rng.uniform(-0.25, 0.25, n)
    return x, u


def _jac_close(got, want):
    """Tangents agree to rounding: rtol 1e-12 per entry, atol 1e-12 of the
    largest entry (entries span ~20 decades across the state)."""
    np.testing.assert_allclose(got, want, rtol=1e-12,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("variant", VARIANTS)
def test_torch_rhs_values_and_tangents_match_jax(variant):
    x, u = _random_states()
    xs = np.vstack([x, np.stack(CORNERS)])
    us = np.concatenate([u, np.linspace(-0.2, 0.2, len(CORNERS))])
    z = np.concatenate([xs, us[:, None]], axis=1)        # (n, 6): x then u

    def jf(zz):
        return jpress.rhs(zz[:5], zz[5], variant=variant)

    want = np.asarray(jax.vmap(jf)(jnp.asarray(z)))
    want_J = np.asarray(jax.vmap(jax.jacfwd(jf))(jnp.asarray(z)))

    got, got_J = dual.linearize(
        lambda zz: press.rhs(zz[..., :5], zz[..., 5], variant=variant),
        torch.from_numpy(z))
    # The JAX package's own bound against its numpy transcription.
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(
        press.rhs(torch.from_numpy(xs), torch.from_numpy(us),
                  variant=variant).numpy(), want, rtol=1e-12, atol=1e-9)
    assert np.all(np.isfinite(got_J.numpy())), variant
    _jac_close(got_J.numpy(), want_J)


@pytest.mark.parametrize("variant", VARIANTS)
def test_torch_measure_matches_jax(variant):
    x, _ = _random_states(seed=1)
    xs = np.vstack([x, np.stack(CORNERS)])
    want = np.asarray(jpress.measure(jnp.asarray(xs), variant=variant))
    got = press.measure(torch.from_numpy(xs), variant=variant).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)


def test_torch_force_flows_friction_match_jax():
    x, _ = _random_states(seed=2)
    xs = np.vstack([x, np.stack(CORNERS)])
    t = torch.from_numpy(xs)
    j = jnp.asarray(xs)
    np.testing.assert_allclose(
        press.forging_force(t[:, 0], t[:, 1]).numpy(),
        np.asarray(jpress.forging_force(j[:, 0], j[:, 1])), rtol=1e-12,
        atol=1e-6)
    for got, want in zip(press.valve_flows(t[:, 2], t[:, 3], t[:, 4]),
                         jpress.valve_flows(j[:, 2], j[:, 3], j[:, 4])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(press.friction(t[:, 1]).numpy(),
                               np.asarray(jpress.friction(j[:, 1])),
                               rtol=1e-12)


def test_torch_tangents_at_ties_follow_jax():
    """At exact ties JAX gives maximum/clip a tangent of one half and abs
    +1 at 0; the port's duals follow JAX there, not torch's own rules."""
    a = jnp.asarray([0.0, 1.0, -1.0, 2.0])
    for jfn, tfn in [
            (lambda v: jnp.maximum(v, 0.0), lambda v: dual.maximum(v, 0.0)),
            (lambda v: jnp.minimum(v, 1.0), lambda v: dual.minimum(v, 1.0)),
            (lambda v: jnp.clip(v, -1.0, 1.0),
             lambda v: dual.clip(v, -1.0, 1.0)),
            (jnp.abs, dual.abs)]:
        want = np.asarray(jax.vmap(jax.grad(jfn))(a))
        _, J = dual.linearize(lambda v: tfn(v[..., 0])[..., None],
                              torch.from_numpy(np.array(a))[:, None])
        np.testing.assert_array_equal(J[:, 0, 0].numpy(), want)


def test_torch_duals_match_torch_func_jacfwd():
    """Away from ties the duals agree with PyTorch's own forward mode."""
    x = torch.tensor([0.05, 0.5, 7.5e6, 5.3e6, 0.17, 0.03], dtype=torch.float64)

    def f(z):
        return press.rhs(z[:5], z[5], variant="smooth")

    want = torch.func.jacfwd(f)(x)
    _, got = dual.linearize(f, x)
    _jac_close(got.numpy(), want.numpy())


def test_torch_rhs_float32_nan_free_near_zero_strain():
    """f32: with y just below/above 0 the gated Fd branch stays finite
    (port of the JAX package's regression test)."""
    for y in (-1.6e-4, -1e-9, 0.0, 1e-9, 1e-7):
        x = torch.tensor([y, 0.165, 1.03e7, 2.29e6, 0.0689])
        out = press.rhs(x, torch.tensor(0.2), variant="smooth")
        assert torch.isfinite(out).all(), (y, out)


def test_torch_scaling_matches_jax():
    x, _ = _random_states(seed=3)
    t = torch.from_numpy(x)
    np.testing.assert_allclose(scaling.scale_x(t).numpy(),
                               np.asarray(jscaling.scale_x(jnp.asarray(x))),
                               rtol=1e-15)
    np.testing.assert_allclose(scaling.unscale_x(scaling.scale_x(t)).numpy(),
                               x, rtol=1e-12)
    assert scaling.U_SCALE == jscaling.U_SCALE
    np.testing.assert_array_equal(scaling.X_SCALE, jscaling.X_SCALE)


def test_torch_feasibility_scales_match_jax():
    """The feasibility NLP's scales, the port's own copy."""
    assert scaling.FEAS_U_SCALE == jscaling.FEAS_U_SCALE
    np.testing.assert_array_equal(scaling.FEAS_X_SCALE,
                                  jscaling.FEAS_X_SCALE)
    assert scaling.FEAS_X_SCALE.dtype == jscaling.FEAS_X_SCALE.dtype


def test_torch_press_params_match_jax():
    import dataclasses
    assert dataclasses.asdict(press.DEFAULT_PARAMS) == \
        dataclasses.asdict(jpress.DEFAULT_PARAMS)
    assert press.X0_REFERENCE == jpress.X0_REFERENCE
    p = press.DEFAULT_PARAMS
    assert (p.A1, p.A2, p.A_spread) == (jpress.DEFAULT_PARAMS.A1,
                                        jpress.DEFAULT_PARAMS.A2,
                                        jpress.DEFAULT_PARAMS.A_spread)
