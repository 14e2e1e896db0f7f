"""The port's surrogate chain against the JAX package (float64, CPU):
scalers, windows and splits, metrics, teacher-forced and free-running
rollouts, the training loop (with the JAX package's own batch tables and
initial weights) and the surrogate pipeline.

The JAX pipeline always casts its windows to float32; to hold the port's
float64 run against it, the JAX pipeline module's ``np`` is replaced, in
the test only, by a NumPy whose ``float32`` is ``float64``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from forging_control_tpu.eval import metrics as jmetrics
from forging_control_tpu.nn import datasets as jdatasets
from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import surrogate_eval as jsurrogate_eval
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import surrogate as jsurrogate
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.eval import metrics
from forging_control_tpu_torch.loop.closed_loop import Telemetry
from forging_control_tpu_torch.nn import (datasets, scalers, surrogate_eval,
                                          train)
from forging_control_tpu_torch.pipelines import config
from forging_control_tpu_torch.pipelines import surrogate


def _jax_params(seed, hidden_dim=8, num_layers=2):
    return jax.tree.map(np.asarray, jlstm.init(
        jax.random.PRNGKey(seed), hidden_dim=hidden_dim,
        num_layers=num_layers, dtype=jnp.float64))


def _assert_params_close(model, params, **tol):
    got = interop.lstm_params_to_numpy(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_allclose(g, np.asarray(w), **tol)


@pytest.mark.parametrize("kind", sorted(scalers.FITTERS))
def test_torch_scalers_match_jax(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(200, 5) * [1.0, 1e7, 3e7, 0.4, 0.4]
    x[:, 3] = 0.0                     # a zero column: sklearn's scale 1
    sc, jsc = scalers.fit(kind, x), jscalers.fit(kind, x)
    np.testing.assert_allclose(sc.shift.numpy(), np.asarray(jsc.shift),
                               rtol=1e-15, atol=0)
    np.testing.assert_allclose(sc.scale.numpy(), np.asarray(jsc.scale),
                               rtol=1e-15, atol=0)
    xs = sc.transform(torch.from_numpy(x))
    np.testing.assert_allclose(xs.numpy(),
                               np.asarray(jsc.transform(jnp.asarray(x))),
                               rtol=1e-15, atol=1e-15)
    np.testing.assert_allclose(sc.inverse(xs).numpy(), x, rtol=1e-12,
                               atol=1e-9)


@pytest.mark.parametrize("traj_len", [None, 300, 7])
def test_torch_windows_and_split_match_jax(traj_len):
    rng = np.random.RandomState(1)
    feats, targets = rng.randn(900, 5), rng.randn(900, 4)
    x, y = datasets.windows(feats, targets, 10, traj_len=traj_len)
    jx, jy = jdatasets.windows(feats, targets, 10, traj_len=traj_len)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    assert x.shape == (900, 10, 5)
    if traj_len == 300:
        # No window straddles a trajectory reset: the window ending at the
        # first row of trajectory 1 repeats that row.
        np.testing.assert_array_equal(x[300], np.repeat(feats[300:301], 10, 0))
        np.testing.assert_array_equal(y[299], targets[299])
    for n in (10, 900, 1001):
        assert datasets.split_603030(n) == jdatasets.split_603030(n)
    tr, va, te = datasets.split_603030(900)
    assert (tr, va, te) == (slice(0, 540), slice(540, 720), slice(720, 900))


def test_torch_metrics_match_jax():
    rng = np.random.RandomState(2)
    a, b = rng.randn(300), rng.randn(300)
    for f, jf in ((metrics.mae, jmetrics.mae), (metrics.rmse, jmetrics.rmse),
                  (metrics.r2, jmetrics.r2)):
        np.testing.assert_allclose(float(f(torch.from_numpy(a),
                                           torch.from_numpy(b))),
                                   float(jf(jnp.asarray(a), jnp.asarray(b))),
                                   rtol=1e-13)
    got = metrics.tracking_metrics(a, b)
    want = jmetrics.tracking_metrics(jnp.asarray(a), jnp.asarray(b))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-13)
    np.testing.assert_allclose(float(metrics.command_effort(a)),
                               float(jmetrics.command_effort(jnp.asarray(a))),
                               rtol=1e-14)
    assert metrics.latency_stats(np.abs(a)) == jmetrics.latency_stats(
        np.abs(a))


def _results(rng, n_traj, t):
    return {k: rng.randn(n_traj, t)
            for k in ("y", "y_dot", "p1", "p2", "z", "u")}


def test_torch_surrogate_rollouts_match_jax():
    """build_feature_track from a results dict and from Telemetry,
    teacher_forced and free_running, fidelity_metrics: full width,
    float64, 1e-10."""
    params = _jax_params(3, hidden_dim=50, num_layers=3)
    model = interop.lstm_params_from_numpy(params, device="cpu")
    rng = np.random.RandomState(4)
    res = _results(rng, 2, 40)
    sc = scalers.fit("maxabs", np.abs(rng.randn(50, 5)) * 3)
    jsc = jscalers.Scaler(jnp.asarray(sc.shift.numpy()),
                          jnp.asarray(sc.scale.numpy()))
    track = surrogate_eval.build_feature_track(res, sc, traj=1)
    jtrack = jsurrogate_eval.build_feature_track(res, jsc, traj=1)
    np.testing.assert_allclose(track.numpy(), jtrack, rtol=1e-15, atol=0)

    x = torch.from_numpy(np.stack([res[k] for k in
                                   ("y", "y_dot", "p1", "p2", "z")], -1))
    telem = Telemetry(x=x, u=torch.from_numpy(res["u"]), ref=None, Fd=None,
                      w=None, diag=None)
    assert torch.equal(surrogate_eval.build_feature_track(telem, sc, traj=1),
                       track)

    tf = surrogate_eval.teacher_forced(model, track, 10)
    jtf = jsurrogate_eval.teacher_forced(params, jtrack, 10)
    np.testing.assert_allclose(tf.numpy(), jtf, rtol=1e-10, atol=1e-10)
    fr = surrogate_eval.free_running(model, track, 10)
    jfr = jsurrogate_eval.free_running(params, jtrack, 10)
    assert fr.shape == jfr.shape == (30, 4)
    np.testing.assert_allclose(fr.numpy(), jfr, rtol=1e-10, atol=1e-10)

    truth = np.vstack([jtrack[1:, :4], jtrack[-1:, :4]])
    got = surrogate_eval.fidelity_metrics(tf, truth)
    want = jsurrogate_eval.fidelity_metrics(jtf, truth)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-12)


def _table(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 10, 5)
    y = np.tanh(x[:, -1, :4] + 0.3 * x[:, -2, 1:]) + 0.1 * rng.randn(n, 4)
    return x, y


def test_torch_train_surrogate_matches_jax():
    """H = 8, L = 2, 2 epochs, batch 32 (the trailing 200 mod 32 rows of
    each epoch dropped), with the JAX package's initial weights and batch
    tables: losses and final weights to 1e-8."""
    params = _jax_params(5)
    xt, yt = _table(6, 200)
    xv, yv = _table(7, 50)
    epochs, bs = 2, 32
    want_p, want = jtrain.train_surrogate(
        jax.tree.map(jnp.asarray, params), xt, yt, xv, yv, epochs=epochs,
        batch_size=bs, seed=0)
    perms = [np.asarray(jtrain._epoch_perm(k, len(xt), bs))
             for k in jax.random.split(jax.random.PRNGKey(0), epochs)]
    assert perms[0].shape == (6, 32)

    model = interop.lstm_params_from_numpy(params, device="cpu")
    seen = []
    model, rep = train.train_surrogate(
        model, *map(torch.from_numpy, (xt, yt, xv, yv)), epochs=epochs,
        batch_size=bs, perms=perms, log_fn=lambda *a: seen.append(a))
    np.testing.assert_allclose(rep.train_losses, want.train_losses,
                               rtol=1e-8)
    np.testing.assert_allclose(rep.val_losses, want.val_losses, rtol=1e-8)
    assert [s[0] for s in seen] == [0, 1]
    _assert_params_close(model, want_p, rtol=1e-8, atol=1e-8)


def test_torch_train_surrogate_own_perms():
    """Without perms: batch tables from a seeded torch.Generator, the same
    for the same seed; the trailing n mod batch_size rows dropped."""
    gen = torch.Generator().manual_seed(0)
    table = train.epoch_perm(gen, 200, 32)
    assert table.shape == (6, 32) and len(set(table.flatten().tolist())) == 192
    assert train.epoch_perm(gen, 20, 32).shape == (1, 20)
    xt, yt = _table(8, 64)
    runs = []
    for _ in range(2):
        model = interop.lstm_params_from_numpy(_jax_params(9), device="cpu")
        runs.append(train.train_surrogate(
            model, *map(torch.from_numpy, (xt, yt, xt, yt)), epochs=2,
            batch_size=16, seed=3)[1])
    assert runs[0].train_losses == runs[1].train_losses
    assert all(np.isfinite(runs[0].val_losses))
    assert train.l1_loss(torch.ones(3), torch.zeros(3)) == 1.0


class _Float64Numpy:
    """NumPy whose float32 is float64 (see the module docstring)."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


def _pipeline_data():
    rng = np.random.RandomState(10)
    out = []
    for n_traj in (2, 1):
        t = np.arange(300) / 300.0
        r = {k: (np.sin(2 * np.pi * (i + 1) * t + rng.rand())[None]
                 * rng.uniform(0.5, 2.0, (n_traj, 1))
                 + 0.05 * rng.randn(n_traj, 300))
             for i, k in enumerate(("y", "y_dot", "p1", "p2", "z", "u"))}
        r["p1"] *= 1e7
        r["p2"] *= 2e7
        out.append(r)
    return out


@pytest.mark.parametrize("training", [True, False])
def test_torch_surrogate_pipeline_matches_jax(training, monkeypatch):
    """pipelines.surrogate.run against the JAX package's on 900 rows (3
    trajectories of 300 from two files), H = 8, L = 2, 2 epochs, batch 32,
    with JAX's initial weights from PRNGKey(seed) and its batch tables:
    test and closed-loop metrics to rtol 1e-8."""
    results = _pipeline_data()
    flags = config.Flags(enable_training=training)
    cfg = config.SurrogateConfig(hidden_dim=8, num_layers=2, epochs=2,
                                 batch_size=32, flags=flags)
    jcfg = jconfig.SurrogateConfig(
        hidden_dim=8, num_layers=2, epochs=2, batch_size=32,
        flags=jconfig.Flags(enable_training=training))
    monkeypatch.setattr(jsurrogate, "np", _Float64Numpy())
    want = jsurrogate.run(results, jcfg, seed=0, eval_results=results[0],
                          dtype=jnp.float64)

    init = _jax_params(0)
    n_train = len(surrogate.prepare(results, 10, dtype=torch.float64,
                                    device="cpu").train[0])
    assert n_train == 540
    perms = [np.asarray(jtrain._epoch_perm(k, n_train, 32))
             for k in jax.random.split(jax.random.PRNGKey(0), 2)]
    art = surrogate.run(results, cfg, seed=0, eval_results=results[0],
                        dtype=torch.float64, device="cpu", init_params=init,
                        perms=perms)
    for got, ref in ((art.test_metrics, want.test_metrics),
                     (art.closed_loop_metrics, want.closed_loop_metrics)):
        assert got.keys() == ref.keys()
        for k in ref:
            if k != "Training_time":
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-8,
                                           atol=1e-12)
    np.testing.assert_allclose(art.state_scaler.scale.numpy(),
                               np.asarray(want.state_scaler.scale),
                               rtol=1e-15)
    _assert_params_close(art.model, want.params, rtol=1e-8, atol=1e-8)
    assert len(art.train_report.train_losses) == (2 if training else 0)
    if training:
        np.testing.assert_allclose(art.train_report.train_losses,
                                   want.train_report.train_losses, rtol=1e-8)


def test_torch_surrogate_pipeline_default_init_on_cpu():
    """Without init_params the weights come from a seeded torch.Generator:
    a run is finite and repeats exactly for the same seed."""
    results = _pipeline_data()
    cfg = config.SurrogateConfig(hidden_dim=8, num_layers=2, epochs=1,
                                 batch_size=64)
    a, b = (surrogate.run(results, cfg, seed=1, device="cpu")
            for _ in range(2))
    assert a.test_metrics["MAE"] == b.test_metrics["MAE"]
    assert np.isfinite(a.test_metrics["MAE"])
    assert a.closed_loop_metrics is None
    assert a.model.w_out.dtype == torch.float32
