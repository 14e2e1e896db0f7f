"""The whole slice against the JAX package (float64, CPU): the batched
closed loop — reference stream, MPC solve, RK4 plant step with process
noise, telemetry.

The JAX run is ``run_batch`` on its fused explicit-batch path (SQP with
``linsolve="pallas"``, the Pallas kernel in interpret mode, as the JAX
package's own tests run it on the CPU; or the iLQR backend).  Its recorded
process noise ``Telemetry.w`` is fed to the port's ``run_batch``, since
``jax.random`` streams cannot be reproduced in torch.  Bounds are those of
the JAX package's fused-vs-vmap loop test (tests/test_loop.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.refgen import streams

B, N, T = 3, 5, 6
LOOP = jcl.LoopConfig(t_steps=T, variant="smooth",
                      process_std=(5e-1, 2e0, 5e7, 5e7, 2e0))
CFG = jsqp.MPCConfig(horizon=N, variant="smooth", gn_iters=2, al_iters=1)


def _refs():
    # The work plateau for the first steps, then the return plateau, so the
    # short run still crosses a reference step.
    return jstreams.reference_table(B, "supervised", t_steps=2 * T)[:, T // 2:
                                                                    T // 2 + T]


@functools.lru_cache(maxsize=None)
def _jax_run(backend):
    ctrl = jcl.MPCController(CFG, backend=backend,
                             linsolve="pallas" if backend == "sqp" else None)
    assert ctrl.supports_batch          # the fused explicit-batch path
    x0 = jnp.tile(jnp.asarray(jcl.press.X0_REFERENCE, jnp.float64), (B, 1))
    _, telem = jax.jit(lambda x, r, k: jcl.run_batch(LOOP, ctrl, x, r, k))(
        x0, jnp.asarray(_refs()), jax.random.PRNGKey(7))
    return dataclasses.asdict(ctrl), jax.tree.map(np.array, telem)


@pytest.mark.parametrize("backend", ["sqp", "ilqr"])
def test_torch_closed_loop_matches_jax(backend):
    ctrl_d, want = _jax_run(backend)
    ctrl = interop.mpc_controller_from_dict(ctrl_d)
    assert ctrl.backend == backend and ctrl.linsolve == "kernel"
    loop_cfg = interop.loop_config_from_dict(dataclasses.asdict(LOOP))
    x0 = np.tile(np.array(press.X0_REFERENCE), (B, 1))
    refs = streams.reference_table(B, "supervised", t_steps=2 * T)
    x_final, telem = cl.run_batch(loop_cfg, ctrl, x0,
                                  refs[:, T // 2:T // 2 + T],
                                  process_noise=want.w, device="cpu")
    got = interop.telemetry_to_numpy(telem)

    assert got["u"].shape == (B, T) and got["x"].shape == (B, T, 5)
    np.testing.assert_array_equal(got["w"], want.w)
    np.testing.assert_array_equal(got["ref"], want.ref)
    np.testing.assert_allclose(got["u"], want.u, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["x"], want.x, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["Fd"], want.Fd, rtol=1e-9, atol=1e-6)
    np.testing.assert_array_equal(got["diag"]["iters"], want.diag.iters)
    np.testing.assert_allclose(got["diag"]["obj"], want.diag.obj, rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got["diag"]["inf_du"], want.diag.inf_du,
                               rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(x_final.numpy()[:, 1], want.x[:, -1, 1],
                               rtol=1e-9, atol=1e-9)   # smooth h keeps y_dot
    # The loop really moved: the reference step and the noise show.
    assert np.ptp(got["u"]) > 1e-3 and np.all(np.isfinite(got["x"]))


def test_torch_function_controller_matches_jax():
    """A stateless batched policy through both loops (the JAX one takes
    its per-trajectory vmap path), no noise."""
    def fn(x, r, up):
        return 0.05 * (r - x[..., 1]) + 0.5 * up

    loop = jcl.LoopConfig(t_steps=T, variant="smooth")
    x0 = np.tile(np.array(press.X0_REFERENCE), (B, 1))
    _, want = jax.jit(lambda x, r, k: jcl.run_batch(
        loop, jcl.FunctionController(fn), x, r, k))(
        jnp.asarray(x0), jnp.asarray(_refs()), jax.random.PRNGKey(0))
    _, telem = cl.run_batch(
        interop.loop_config_from_dict(dataclasses.asdict(loop)),
        cl.FunctionController(fn), x0, _refs(), device="cpu")
    np.testing.assert_allclose(telem.u.numpy(), np.asarray(want.u),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(telem.x.numpy(), np.asarray(want.x),
                               rtol=1e-12, atol=1e-6)
    assert np.all(telem.diag.iters.numpy() == 0)


def test_torch_run_batch_noise_from_generator():
    """Configured noise needs a generator (or pre-drawn noise); a seeded
    generator makes the run repeatable and Telemetry.w records the draws."""
    loop = cl.LoopConfig(t_steps=3, variant="smooth",
                         process_std=(0.0, 1e-3, 1e3, 1e3, 0.0),
                         meas_std=(0.0, 1e-4, 0.0, 0.0, 0.0))
    ctrl = cl.FunctionController(lambda x, r, up: 0.1 * r)
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64).repeat(4, 1)
    refs = torch.full((4, 3), 0.3, dtype=torch.float64)
    with pytest.raises(ValueError, match="Generator"):
        cl.run_batch(loop, ctrl, x0, refs, device="cpu")
    runs = [cl.run_batch(loop, ctrl, x0, refs,
                         torch.Generator().manual_seed(3), device="cpu")[1]
            for _ in range(2)]
    assert torch.equal(runs[0].x, runs[1].x)
    w = runs[0].w
    assert w.shape == (4, 3, 5) and torch.all(w[..., 0] == 0)
    assert torch.all(w[..., 2] != 0)


def test_torch_backend_resolution():
    assert cl.resolve_backend("auto", 10) == "sqp"
    assert cl.resolve_backend("auto", 25) == "ilqr"
    assert cl.resolve_backend("auto", 10) == jcl.resolve_backend("auto", 10)
    assert cl.MPCController(cl.sqp.MPCConfig(horizon=20),
                            backend="auto").backend == "ilqr"
    with pytest.raises(ValueError, match="linsolve"):
        cl.MPCController(cl.sqp.MPCConfig(), linsolve="pallas")
    assert interop.linsolve_from_jax("unrolled") == "plain"


def test_torch_single_stream_stepper():
    """make_stepper reproduces run_batch at B = 1 step by step: the same
    controller warm-start evolution, the same noise, the same commands
    (the port of tests/test_loop.py's stepper test); with a generator it
    draws the noise itself, repeatably."""
    loop_cfg = cl.LoopConfig(t_steps=8, variant="smooth",
                             process_std=(5e-1, 2e0, 5e7, 5e7, 2e0))
    ctrl = cl.MPCController(cl.sqp.MPCConfig(horizon=5, variant="smooth",
                                             gn_iters=3, al_iters=1))
    refs = torch.full((1, 8), 0.3, dtype=torch.float64)
    w = torch.randn(1, 8, 5, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64) * torch.tensor(loop_cfg.process_std,
                                                        dtype=torch.float64)
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float64)
    _, telem = cl.run_batch(loop_cfg, ctrl, x0[None], refs, process_noise=w,
                            device="cpu")
    step, carry = cl.make_stepper(loop_cfg, ctrl, x0=x0, dtype=torch.float64,
                                  device="cpu")
    us = []
    for t in range(8):
        carry, u = step(carry, refs[0, t], process_noise=w[0, t])
        assert u.shape == ()
        us.append(u.item())
    np.testing.assert_allclose(us, telem.u[0].numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(carry.x_meas[0].numpy(),
                               telem.x[0, -1].numpy(), rtol=1e-12)
    runs = []
    for _ in range(2):
        step, carry = cl.make_stepper(loop_cfg, ctrl, dtype=torch.float64,
                                      generator=torch.Generator().manual_seed(
                                          2), device="cpu")
        runs.append([step(carry, 0.3)[1].item(),
                     step(step(carry, 0.3)[0], 0.3)[1].item()])
    assert runs[0] == runs[1]


def test_torch_controller_latency_metrics_cpu_columns():
    """The reference-format latency columns come from the CPU stepper; on
    the CPU there is no Tunnel_time column (the card adds it)."""
    loop_cfg = cl.LoopConfig(t_steps=6, variant="smooth")
    ctrl = cl.FunctionController(
        lambda x, ref, u_prev: torch.clamp(0.05 * (ref - x[:, 1]), -0.2, 0.2))
    refs = torch.full((6,), 0.3)
    times = cl.stepper_latency(loop_cfg, ctrl, refs, device="cpu")
    assert times.shape == (5,) and np.all(times > 0)
    m = cl.controller_latency_metrics(loop_cfg, ctrl, refs, device="cpu")
    assert list(m) == ["Mean_time", "Std_time", "Median_time", "25_perc",
                       "75_perc"]
    assert all(np.isfinite(v) and v >= 0 for v in m.values())
