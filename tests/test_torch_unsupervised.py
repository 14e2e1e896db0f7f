"""``pipelines.unsupervised.run`` against the JAX package's (float64, CPU),
in the "surrogate" and "plant" train modes ("dagger" in
``test_torch_unsupervised_dagger.py``), on a tiny dataset (4 trajectories
x 40 steps), horizon 3, lookback 4, a surrogate of H = 8, L = 2: with the
JAX package's initial
weights, batch tables and reference streams passed in, the losses, the
returned controller, the test and closed-loop metrics and the surrogate's
drift agree within 1e-8, and the checkpoint it writes loads in both
packages with the same meta.

Both pipelines round their windows and imitation pairs through float32
whatever the dtype, and both DAgger rollouts run in float32
(``test_torch_float64_parity.py`` holds them unpatched).  Here the float64
runs are held against each other with, in the test only, both pipeline
modules' ``np`` replaced by a NumPy whose ``float32`` is ``float64`` and
both packages' DAgger rollouts in float64."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import unsupervised as junsupervised
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.utils import checkpoint as jcheckpoint
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import scalers, train
from forging_control_tpu_torch.pipelines import config, unsupervised
from forging_control_tpu_torch.utils import checkpoint

T_TRAJ = 8
TIMING = {"Mean_time", "Amortized_time", "Training_time"}
KW = dict(horizon=3, lookback=4, epochs=2, total_batch_size=24,
          closed_loop_val_traj=2, latency_profile=False, plant_steps=2,
          plant_n_traj=2, plant_pretrain_epochs=2, dagger_rounds=2,
          dagger_n_traj=2, dagger_epochs=2)


class _Float64Numpy:
    """NumPy whose float32 is float64 (see the module docstring)."""

    float32 = np.float64

    def __getattr__(self, name):
        return getattr(np, name)


def _dataset():
    rng = np.random.RandomState(7)
    t = np.arange(40) / 40.0
    scale = {"y": 0.05, "y_dot": 0.5, "p1": 1e7, "p2": 2e7, "z": 0.1,
             "ref": 0.5, "u": 0.2}
    return {k: (np.sin(2 * np.pi * (i + 1) * t + rng.rand())[None]
                * rng.uniform(0.5, 1.0, (4, 1)) + 0.05 * rng.randn(4, 40))
            * scale[k] for i, k in enumerate(scale)}


def _surrogate(results):
    params = jax.tree.map(np.asarray, jlstm.init(
        jax.random.PRNGKey(5), hidden_dim=8, num_layers=2,
        dtype=jnp.float64))
    track = np.stack([results[k].ravel() for k in
                      ("y_dot", "p1", "p2", "z", "u")], axis=1)
    sc = scalers.fit_maxabs(track)
    return (params, jscalers.fit_maxabs(track),
            interop.lstm_params_from_numpy(params, device="cpu"), sc)


def _hooks(mode):
    """The JAX pipeline's draws at seed 0: initial weights, the mode's
    batch tables, and its reference streams."""
    n_full = int(4 * 39 * 0.6)                 # full-density training rows
    refs = {"val": np.asarray(jstreams.sample_references(
        jax.random.PRNGKey(9000), KW["closed_loop_val_traj"], "unsupervised",
        T_TRAJ, dtype=jnp.float64))}
    key, plant = jax.random.PRNGKey(0), []
    for _ in range(KW["plant_steps"]):
        key, k_ref, _ = jax.random.split(key, 3)
        plant.append(np.asarray(jstreams.sample_references(
            k_ref, KW["plant_n_traj"], "unsupervised", T_TRAJ,
            dtype=jnp.float64)))

    def tables(seed, epochs, n, bs):
        return [np.asarray(jtrain._epoch_perm(k, n, bs)) for k in
                jax.random.split(jax.random.PRNGKey(seed), epochs)]

    if mode == "surrogate":
        perms = tables(0, KW["epochs"], 96 // 3, 24 // 3)
    elif mode == "plant":
        perms = tables(0, KW["plant_pretrain_epochs"], n_full, 256)
        refs["plant"] = plant
    else:
        perms, refs["dagger"], refs["plant"] = [], [], plant
        key = jax.random.PRNGKey(77)
        for r in range(KW["dagger_rounds"]):
            perms.append(tables(r, KW["dagger_epochs"],
                                n_full + r * KW["dagger_n_traj"] * T_TRAJ,
                                256))
            key, k_ref, _ = jax.random.split(key, 3)
            refs["dagger"].append(np.asarray(jstreams.sample_references(
                k_ref, KW["dagger_n_traj"], "unsupervised", T_TRAJ,
                dtype=jnp.float32)))
    init = jax.tree.map(np.asarray, jfnn.init(jax.random.PRNGKey(0),
                                              dtype=jnp.float64)[0])
    return init, perms, refs


@pytest.mark.parametrize("mode", ["surrogate", "plant"])
def test_torch_unsupervised_run_matches_jax(mode, tmp_path, monkeypatch):
    check_mode(mode, tmp_path, monkeypatch)


def check_mode(mode, tmp_path, monkeypatch):
    """One train mode of both pipelines (also run by
    ``test_torch_unsupervised_dagger.py`` for ``"dagger"``)."""
    results = _dataset()
    jparams, jsc, model, sc = _surrogate(results)
    monkeypatch.setattr(junsupervised, "np", _Float64Numpy())
    monkeypatch.setattr(unsupervised, "np", _Float64Numpy())
    monkeypatch.setattr(jtrain, "dagger_rollout", functools.partial(
        jtrain.dagger_rollout, dtype=jnp.float64))
    monkeypatch.setattr(train, "dagger_rollout", functools.partial(
        train.dagger_rollout, dtype=torch.float64))
    want = junsupervised.run(
        results, jparams, jsc, jconfig.UnsupervisedConfig(
            train_mode=mode, **KW), dtype=jnp.float64, t_traj=T_TRAJ,
        out_dir=str(tmp_path / "j"))
    init, perms, refs = _hooks(mode)
    art = unsupervised.run(
        results, model, sc, config.UnsupervisedConfig(train_mode=mode, **KW),
        dtype=torch.float64, t_traj=T_TRAJ, out_dir=str(tmp_path / "p"),
        device="cpu", init_params=init, perms=perms, refs=refs)

    rep, jrep = art.train_report, want.train_report
    for name in ("train_losses", "val_losses", "cl_val_losses"):
        assert len(getattr(rep, name)) == len(getattr(jrep, name)), name
        np.testing.assert_allclose(getattr(rep, name), getattr(jrep, name),
                                   rtol=1e-8, err_msg=name)
    assert rep.selected_seed == jrep.selected_seed == 0
    for k, v in art.params.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want.params[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)
    for got, ref in ((art.test_metrics, want.test_metrics),
                     (art.nn_metrics, want.nn_metrics),
                     (art.surrogate_drift, want.surrogate_drift)):
        assert list(got) == list(ref)
        for k in set(ref) - TIMING:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, atol=1e-12,
                                       err_msg=k)
    assert np.ptp(art.nn_telem.u.numpy()) > 1e-4

    rel = "results/NN_controller_unsupervised_N_3.npz"
    metas = [json.load(open(tmp_path / d / (rel + ".meta.json")))
             for d in ("p", "j")]
    assert metas[0] == metas[1]
    assert metas[0]["meta"] == {"train_mode": mode, "pipeline": "unsupervised"}
    p, _, _, meta = checkpoint.load_controller(str(tmp_path / "p" / rel),
                                               device="cpu")
    assert meta["width_dim"] == 1
    back = jcheckpoint.load(str(tmp_path / "p" / rel), {
        "params": dict.fromkeys(interop.FNN_KEYS, 0), "in_scaler": (0, 0),
        "out_scaler": (0, 0)})
    for k, v in p.items():
        np.testing.assert_array_equal(v.numpy(), back["params"][k])
    for name in ("test", "NN"):
        assert (tmp_path / "p" / "Unsupervised" / "Tables" / "Normal"
                / f"{name}_results_N_3.csv").exists()


def test_torch_unsupervised_scalers_and_data_match_jax():
    """prepare_data (float32, as the JAX package casts) and
    fit_controller_scalers give the JAX package's arrays."""
    results = _dataset()
    _, jsc, _, sc = _surrogate(results)
    cfg = config.UnsupervisedConfig(**KW)
    got = unsupervised.prepare_data(results, sc, cfg)
    want = junsupervised.prepare_data(results, jsc,
                                      jconfig.UnsupervisedConfig(**KW))
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(g, w):
            assert a.dtype == np.float32 and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    for g, w in zip(got[3:], want[3:]):
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))
    in_sc, u_sc = unsupervised.fit_controller_scalers(results)
    np.testing.assert_array_equal(in_sc.scale.numpy(), got[3].scale.numpy())
    np.testing.assert_array_equal(u_sc.scale.numpy(), got[4].scale.numpy())
