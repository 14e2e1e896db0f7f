"""The port's wide-panel evaluation against the JAX package's (CPU): the
panel statistics, paired comparison and verdicts from the same telemetry,
exactly; and a small panel rolled through the port's closed loop with the
JAX package's streams and noise, against the JAX package's run (float64,
1e-9)."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.eval import wide_panel as jwp
from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.eval import wide_panel as wp
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.nn import fnn, scalers


class _Telem(NamedTuple):
    x: np.ndarray
    u: np.ndarray
    ref: np.ndarray


def _fake_run(seed, spec):
    """A loop engine that returns seeded telemetry of the panel's shape."""
    rng = np.random.RandomState(seed)
    B, T = spec.n_traj, spec.t_traj
    telem = _Telem(x=rng.randn(B, T, 5), u=rng.randn(B, T),
                   ref=rng.randn(B, T))
    return lambda x0, refs, key: (None, telem)


@pytest.mark.parametrize("protocol", [False, True])
def test_torch_wide_panel_statistics_match_jax(protocol):
    spec = wp.PanelSpec(n_streams=5, n_noise_reps=3, t_traj=7,
                        include_protocol_streams=protocol)
    jspec = jwp.PanelSpec(n_streams=5, n_noise_reps=3, t_traj=7,
                          include_protocol_streams=protocol)
    assert spec.n_traj == jspec.n_traj
    res = [wp.run_controller(spec, None, run_fn=_fake_run(s, spec),
                             device="cpu") for s in (0, 1)]
    jres = [jwp.run_controller(jspec, None, run_fn=_fake_run(s, spec))
            for s in (0, 1)]
    for r, j in zip(res, jres):
        for name in ("mae", "rmse", "command"):
            np.testing.assert_array_equal(getattr(r, name),
                                          getattr(j, name))
        assert r.summarize() == j.summarize()
        for recorded in (0.5, 1.5, 3.0):
            assert (wp.verdict_vs_scalar(r, recorded)
                    == jwp.verdict_vs_scalar(j, recorded))
    assert wp.compare(*res) == jwp.compare(*jres)
    assert wp.compare(res[0], res[0])["verdict"] == "tie"
    with pytest.raises(ValueError, match="identical"):
        wp.compare(res[0], wp.PanelResult(
            wp.PanelSpec(n_streams=4), res[0].mae, res[0].rmse,
            res[0].command))


def test_torch_wide_panel_run_matches_jax():
    """2 streams x 2 noise realisations x 5 steps with the deployment noise:
    the JAX package's panel streams and recorded noise through the port's
    loop give its per-trajectory errors."""
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(0), hidden_dim=16, dtype=jnp.float64)[0])
    shifts = (0.01 * rng.randn(3), 0.01 * rng.randn(1))
    sc_scales = (rng.uniform(0.5, 1.0, 3), rng.uniform(0.2, 0.3, 1))
    kw = dict(n_streams=2, n_noise_reps=2, t_traj=5)
    jspec, spec = jwp.PanelSpec(**kw), wp.PanelSpec(**kw)
    jctrl = jcl.FunctionController(jfnn.make_policy(
        params, *[jscalers.Scaler(jnp.asarray(a), jnp.asarray(b))
                  for a, b in zip(shifts, sc_scales)]))
    loop = jcl.LoopConfig(t_steps=5, process_std=jspec.process_std)
    seen = {}

    def jrun(x, r, k):
        out = jcl.run_batch(loop, jctrl, x, r, k)
        seen["telem"] = out[1]
        return out

    want = jwp.run_controller(jspec, jctrl, dtype=jnp.float64, run_fn=jrun)
    ctrl = cl.FunctionController(fnn.make_policy(
        interop.fnn_params_from_numpy(params, device="cpu"),
        *[scalers.Scaler(torch.from_numpy(a), torch.from_numpy(b))
          for a, b in zip(shifts, sc_scales)]))
    got = wp.run_controller(
        spec, ctrl, dtype=torch.float64, device="cpu",
        refs=np.asarray(jwp.panel_refs(jspec, jnp.float64)),
        process_noise=np.asarray(seen["telem"].w))
    for name in ("mae", "rmse", "command"):
        assert getattr(got, name).shape == (2, 2)
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_torch_wide_panel_draws_are_seeded():
    """The port's own streams come from the spec's seeds: the same spec
    gives the same panel, the CPython streams lead when asked for, and the
    stream seed changes the plateaus."""
    spec = wp.PanelSpec(n_streams=3, t_traj=6, include_protocol_streams=True)
    a = wp.panel_refs(spec, torch.float64, device="cpu")
    assert a.shape == (5, 6)
    assert torch.equal(a, wp.panel_refs(spec, torch.float64, device="cpu"))
    other = wp.panel_refs(wp.PanelSpec(n_streams=3, t_traj=6, stream_key=8,
                                       include_protocol_streams=True),
                          torch.float64, device="cpu")
    assert torch.equal(a[:2], other[:2]) and not torch.equal(a[2:], other[2:])
