"""The port's DAgger against the JAX package (float64, CPU):
``dagger_rollout`` at N = 5, T = 3 with mixing and process noise (the JAX
package's per-trajectory draws recomputed here) at the SQP parity test's
tolerances; ``train_dagger`` for 2 rounds with the JAX package's batch
tables and reference streams, 1e-8; and ``pipelines.supervised.run`` with
``train_mode="dagger"``, 1e-8.

Both packages' ``train_dagger`` roll out in float32 (the
``dagger_rollout`` default); the test patches both rollouts to float64.
Both packages round the full-density imitation set through float32
whatever the run's dtype; the float64 runs are held against each other
with both pipeline modules' ``np`` replaced by a NumPy whose ``float32`` is
``float64``, in the test only."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import supervised as jsupervised
from forging_control_tpu.pipelines import unsupervised as junsupervised
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import scalers, train
from forging_control_tpu_torch.pipelines import (config, supervised,
                                                 unsupervised)
from forging_control_tpu_torch.solver import sqp

PROCESS_STD = (5e-1, 2e0, 5e7, 5e7, 2e0)


def _controller(seed):
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(seed), hidden_dim=16, dtype=jnp.float64)[0])
    shifts = (0.01 * rng.randn(3), 0.01 * rng.randn(1))
    scales = (rng.uniform(0.5, 1.0, 3), rng.uniform(0.2, 0.3, 1))
    jsc = [jscalers.Scaler(jnp.asarray(a), jnp.asarray(b))
           for a, b in zip(shifts, scales)]
    sc = [scalers.Scaler(torch.from_numpy(a), torch.from_numpy(b))
          for a, b in zip(shifts, scales)]
    return params, jsc, sc


def _rollout_noise(key, B, T):
    """``dagger_rollout``'s process noise: per-trajectory keys, split in
    two at each step, the second half drawing N(0, 1) x process_std."""
    keys = jax.random.split(key, B)
    out = []
    for _ in range(T):
        ks = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
        out.append(np.asarray(jax.vmap(lambda k: jax.random.normal(
            k, (5,), jnp.float64))(ks[:, 1])) * np.asarray(PROCESS_STD))
        keys = ks[:, 0]
    return np.stack(out, axis=1)


def test_torch_dagger_rollout_matches_jax():
    params, jsc, sc = _controller(0)
    B, T = 2, 3
    refs = np.asarray(jstreams.sample_references(
        jax.random.PRNGKey(4), B, "unsupervised", T, dtype=jnp.float64))
    key = jax.random.PRNGKey(9)
    kw = dict(process_std=PROCESS_STD, beta=0.5)
    jf, ju = jtrain.dagger_rollout(params, *jsc, jsqp.MPCConfig(horizon=5),
                                   refs, key, dtype=jnp.float64, **kw)
    f, u = train.dagger_rollout(
        interop.fnn_params_from_numpy(params, device="cpu"), *sc,
        sqp.MPCConfig(horizon=5), refs, dtype=torch.float64,
        process_noise=_rollout_noise(key, B, T), **kw)
    assert f.shape == (B, T, 3) and u.shape == (B, T)
    # The SQP parity test's bound on commands; states as in the closed loop.
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-9,
                               atol=1e-9)
    assert np.ptp(np.asarray(ju)) > 1e-3


def _jax_dagger_draws(monkeypatch, seed, rounds, n_traj, t_steps, variant,
                      n0, epochs, bs):
    """Patch the JAX rollout to float64; return its per-round reference
    streams and batch tables (the aggregate grows by n_traj x t_steps rows
    a round)."""
    monkeypatch.setattr(jtrain, "dagger_rollout", functools.partial(
        jtrain.dagger_rollout, dtype=jnp.float64))
    key, refs, perms = jax.random.PRNGKey(seed + 77), [], []
    for r in range(rounds):
        n = n0 + r * n_traj * t_steps
        perms.append([np.asarray(jtrain._epoch_perm(k, n, bs)) for k in
                      jax.random.split(jax.random.PRNGKey(seed + r), epochs)])
        key, k_ref, _ = jax.random.split(key, 3)
        refs.append(np.asarray(jstreams.sample_references(
            k_ref, n_traj, variant, t_steps, dtype=jnp.float32)))
    return refs, perms


def _sequence(values):
    it = iter(values)
    return lambda params: next(it)


def test_torch_train_dagger_matches_jax(monkeypatch):
    params, jsc, sc = _controller(1)
    monkeypatch.setattr(train, "dagger_rollout", functools.partial(
        train.dagger_rollout, dtype=torch.float64))
    rng = np.random.RandomState(1)
    x0 = rng.uniform(-0.8, 0.8, (40, 3)).astype(np.float32)
    u0 = rng.uniform(-0.8, 0.8, (40, 1)).astype(np.float32)
    xv, uv = x0[:10], u0[:10]
    seed, rounds, n_traj, t_steps, epochs, bs = 2, 2, 2, 3, 2, 16
    refs, perms = _jax_dagger_draws(monkeypatch, seed, rounds, n_traj,
                                    t_steps, "unsupervised", 40, epochs, bs)
    kw = dict(rounds=rounds, n_traj=n_traj, t_steps=t_steps, epochs=epochs,
              batch_size=bs, seed=seed)
    scores = [0.2, 0.1]                       # round 1 is the best
    want_p, want = jtrain.train_dagger(
        params, *jsc, x0, u0, xv, uv, mpc_cfg=jsqp.MPCConfig(horizon=5),
        closed_loop_val_fn=_sequence(scores), **kw)
    got_p, got = train.train_dagger(
        interop.fnn_params_from_numpy(params, device="cpu"), *sc, x0, u0,
        xv, uv, mpc_cfg=sqp.MPCConfig(horizon=5),
        closed_loop_val_fn=_sequence(scores), perms=perms, refs=refs, **kw)
    assert len(got.train_losses) == rounds * epochs
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-8)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-8)
    assert got.cl_val_losses == want.cl_val_losses == scores
    for k, v in got_p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)


class _Float64Numpy:
    """NumPy whose float32 is float64 (see the module docstring)."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


def _dataset():
    rng = np.random.RandomState(3)
    t = np.arange(50) / 50.0
    out = {}
    for i, k in enumerate(("y_dot", "z", "ref", "u")):
        out[k] = (np.sin(2 * np.pi * (i + 1) * t + rng.rand())[None]
                  * rng.uniform(0.1, 0.5, (4, 1))
                  + 0.02 * rng.randn(4, 50)).astype(np.float32)
    return out


def test_torch_supervised_dagger_run_matches_jax(monkeypatch):
    """``train_mode="dagger"`` at horizon 5: 2 rounds of 2 epochs, one
    relabelling of 2 streams x 3 steps, selection on 16 validation streams
    of 3 steps; the test metrics and the losses within 1e-8."""
    results = _dataset()
    kw = dict(horizon=5, t_traj=3, train_mode="dagger", dagger_rounds=2,
              dagger_n_traj=2, dagger_epochs=2)
    n0 = int(4 * 49 * 0.6)                  # full-density training rows
    refs, perms = _jax_dagger_draws(monkeypatch, 0, 2, 2, 3, "supervised",
                                    n0, 2, 256)
    monkeypatch.setattr(train, "dagger_rollout", functools.partial(
        train.dagger_rollout, dtype=torch.float64))
    monkeypatch.setattr(junsupervised, "np", _Float64Numpy())
    monkeypatch.setattr(unsupervised, "np", _Float64Numpy())
    want = jsupervised.run(results, jconfig.SupervisedConfig(**kw), seed=0,
                           closed_loop_eval=False, dtype=jnp.float64)
    init, _ = jfnn.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    val = np.asarray(jstreams.sample_references(
        jax.random.PRNGKey(9000), 16, "supervised", 3, dtype=jnp.float64))
    art = supervised.run(
        results, config.SupervisedConfig(**kw), seed=0,
        closed_loop_eval=False, dtype=torch.float64, device="cpu",
        init_params=jax.tree.map(np.asarray, init), perms=perms,
        refs={"val": val, "dagger": refs})
    assert list(art.test_metrics) == list(want.test_metrics)
    for k in ("MAE", "RMSE", "R2"):
        np.testing.assert_allclose(art.test_metrics[k], want.test_metrics[k],
                                   rtol=1e-8, err_msg=k)
    rep, jrep = art.train_report, want.train_report
    np.testing.assert_allclose(rep.train_losses, jrep.train_losses, rtol=1e-8)
    np.testing.assert_allclose(rep.cl_val_losses, jrep.cl_val_losses,
                               rtol=1e-8)
    for k, v in art.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want.params[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)
