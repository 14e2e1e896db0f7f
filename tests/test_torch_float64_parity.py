"""Float64 runs of both packages through the Python API, unpatched (CPU).

The JAX package rounds its surrogate windows, its unsupervised triples and
imitation pairs, and DAgger's aggregate, labels and reference draws through
float32 whatever its dtype, then computes in the run's dtype (JAX promotes
float32 inputs with float64 weights).  The port rounds the same arrays at
the same places, so float64 runs of the two agree at the float64 parity
tolerance with no patch on either side: the surrogate pipeline's windows,
the unsupervised ``prepare_data`` and its full-density pairs, and DAgger's
first round at a small size (its relabelled round at float32's, since each
package's float32 rollout rounds on its own)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import surrogate as jsurrogate
from forging_control_tpu.pipelines import unsupervised as junsupervised
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import train
from forging_control_tpu_torch.pipelines import config, surrogate, unsupervised
from forging_control_tpu_torch.solver import sqp
from test_torch_dagger import _controller
from test_torch_surrogate import _pipeline_data
from test_torch_unsupervised import KW, _dataset, _surrogate


class _Stop(Exception):
    pass


def _jax_surrogate_windows(results, monkeypatch) -> dict:
    """The windows the JAX surrogate pipeline builds, caught where it hands
    them on: the training and validation windows at ``train_surrogate``,
    the test windows at the test forward (``lstm.apply``)."""
    seen = {}

    def at_training(params, xt, yt, xv, yv, **kw):
        seen.update(train=(xt, yt), val=(xv, yv))
        raise _Stop

    def at_test(params, x):
        seen["test"] = np.asarray(x)
        raise _Stop

    monkeypatch.setattr(jtrain, "train_surrogate", at_training)
    monkeypatch.setattr(jlstm, "apply", at_test)
    for training in (True, False):
        cfg = jconfig.SurrogateConfig(
            hidden_dim=8, num_layers=2,
            flags=jconfig.Flags(enable_training=training))
        with pytest.raises(_Stop):
            jsurrogate.run(results, cfg, dtype=jnp.float64)
    return seen


def test_torch_surrogate_float64_unpatched_matches_jax(monkeypatch):
    """``surrogate.prepare`` at float64 against the JAX pipeline's windows
    at float64: the same float32 values.  (The JAX pipeline itself stops
    there at float64, as its LSTM scan refuses float32 windows with
    float64 weights; the port's float64 run computes on them, as JAX
    promotes float32 inputs elsewhere.)"""
    results = _pipeline_data()
    want = _jax_surrogate_windows(results, monkeypatch)
    data = surrogate.prepare(results, 10, dtype=torch.float64, device="cpu")
    for split in ("train", "val"):
        for got, ref in zip(getattr(data, split), want[split]):
            assert got.dtype == torch.float64 and ref.dtype == np.float32
            np.testing.assert_array_equal(got.numpy(),
                                          ref.astype(np.float64))
    assert want["test"].dtype == np.float32
    np.testing.assert_array_equal(data.test[0].numpy(),
                                  want["test"].astype(np.float64))
    art = surrogate.run(results, config.SurrogateConfig(
        hidden_dim=8, num_layers=2, epochs=1, batch_size=32),
        dtype=torch.float64, device="cpu")
    assert all(np.isfinite(v) for v in art.test_metrics.values())


def test_torch_unsupervised_data_float64_unpatched_matches_jax():
    """The unsupervised triples (JAX: float32 arrays) and the full-density
    imitation pairs (JAX: float32 values scaled in float64, commands back in
    float32) at float64: the same values."""
    results = _dataset()
    _, jsc, _, sc = _surrogate(results)
    got = unsupervised.prepare_data(results, sc,
                                    config.UnsupervisedConfig(**KW),
                                    dtype=torch.float64)
    want = junsupervised.prepare_data(results, jsc,
                                      jconfig.UnsupervisedConfig(**KW))
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(g, w):
            assert a.dtype == np.float64 and b.dtype == np.float32
            np.testing.assert_array_equal(a, b.astype(np.float64))
    dense = unsupervised._full_density(results, got[3], got[4],
                                       torch.float64)
    jdense = junsupervised._full_density(results, want[3], want[4])
    for a, b in zip(dense, jdense):
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, np.asarray(b, np.float64), rtol=1e-15,
                                   atol=0)


def test_torch_dagger_round_float64_unpatched_matches_jax():
    """``train_dagger`` with float64 weights, unpatched, for 2 rounds: both
    packages aggregate float32 rows (the initial pairs, then one
    relabelling of 2 streams x 3 steps rolled out in float32 on float32
    reference draws)."""
    params, jsc, sc = _controller(1)
    rng = np.random.RandomState(1)
    x0 = rng.uniform(-0.8, 0.8, (40, 3))
    u0 = rng.uniform(-0.8, 0.8, (40, 1))
    xv, uv = x0[:10], u0[:10]
    seed, rounds, n_traj, t_steps, epochs, bs = 2, 2, 2, 3, 2, 16
    # The JAX package's draws: batch tables (the aggregate grows by
    # n_traj x t_steps rows a round) and float32 reference streams.
    key, refs, perms = jax.random.PRNGKey(seed + 77), [], []
    for r in range(rounds):
        perms.append([np.asarray(jtrain._epoch_perm(
            k, 40 + r * n_traj * t_steps, bs)) for k in jax.random.split(
                jax.random.PRNGKey(seed + r), epochs)])
        key, k_ref, _ = jax.random.split(key, 3)
        refs.append(np.array(jstreams.sample_references(
            k_ref, n_traj, "unsupervised", t_steps, dtype=jnp.float32)))
    kw = dict(rounds=rounds, n_traj=n_traj, t_steps=t_steps, epochs=epochs,
              batch_size=bs, seed=seed)
    want_p, want = jtrain.train_dagger(
        params, *jsc, x0, u0, xv, uv, mpc_cfg=jsqp.MPCConfig(horizon=5), **kw)
    got_p, got = train.train_dagger(
        interop.fnn_params_from_numpy(params, device="cpu"), *sc, x0, u0,
        xv, uv, mpc_cfg=sqp.MPCConfig(horizon=5), perms=perms, refs=refs,
        **kw)
    # Round 0 trains on the float32 aggregate: float64's tolerance.
    np.testing.assert_allclose(got.train_losses[:epochs],
                               want.train_losses[:epochs], rtol=1e-8)
    np.testing.assert_allclose(got.val_losses[:epochs],
                               want.val_losses[:epochs], rtol=1e-8)
    # Round 1 adds the relabelled rows, which each package's float32
    # rollout computes with its own rounding (6.3e-7 apart on this run):
    # float32's tolerance from there on.
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-5)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-5)
    for k, v in got_p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
