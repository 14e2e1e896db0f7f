"""Checkpoints move between the JAX package and the port (the surrogate's
and the FNN controller's), and the recorded surrogate checkpoint gives the
JAX package's metrics through the port.

``results_repro/surrogate_params.npz`` is the JAX package's trained
surrogate; the five ``results_repro`` datasets, concatenated in the order
of ``SurrogateConfig.horizons``, give its 24,000 test windows.  The JAX
package's float32 metrics on them are recomputed here and pinned as
``chip_smoke.RECORDED_TEST`` / ``RECORDED_SHADOW``, which the smoke script
holds the card's run against.
"""

from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from forging_control_tpu.nn import datasets as jdatasets
from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import surrogate_eval as jsurrogate_eval
from forging_control_tpu.pipelines import surrogate as jsurrogate
from forging_control_tpu.utils import checkpoint as jcheckpoint
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import lstm, scalers, surrogate_eval
from forging_control_tpu_torch.pipelines import config, generate_data
from forging_control_tpu_torch.pipelines import surrogate
from forging_control_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parents[1]
RECORDED = REPO / "results_repro" / "surrogate_params.npz"
RECORDED_CONTROLLER = REPO / "results_repro" / "results" / \
    "NN_controller_N_10_process_noise.npz"


def _jax_like(hidden_dim, num_layers, readout_bias=True):
    return {"params": jlstm.init(jax.random.PRNGKey(0), hidden_dim=hidden_dim,
                                 num_layers=num_layers,
                                 readout_bias=readout_bias),
            "scaler": jscalers.Scaler(jnp.zeros(5), jnp.ones(5))}


def test_torch_checkpoint_port_save_loads_in_jax(tmp_path):
    model = lstm.init(torch.Generator().manual_seed(0), hidden_dim=8,
                      num_layers=2, dtype=torch.float64, device="cpu")
    sc = scalers.fit("maxabs", np.random.RandomState(0).randn(40, 5))
    path = str(tmp_path / "ck.npz")
    checkpoint.save_surrogate(path, model, sc, meta={"epochs": 2})
    got = jcheckpoint.load(path, _jax_like(8, 2))
    assert jcheckpoint.load_meta(path) == checkpoint.load_meta(path) \
        == {"epochs": 2}
    want = checkpoint.surrogate_tree(model, sc)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), w)
    x = np.random.RandomState(1).randn(5, 10, 5)
    np.testing.assert_allclose(
        np.asarray(jlstm.apply(got["params"], jnp.asarray(x))),
        model.infer(torch.from_numpy(x)).numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("readout_bias", [True, False])
def test_torch_checkpoint_jax_save_loads_in_port(tmp_path, readout_bias):
    params = jlstm.init(jax.random.PRNGKey(1), hidden_dim=8, num_layers=3,
                        dtype=jnp.float64, readout_bias=readout_bias)
    jsc = jscalers.fit_maxabs(np.random.RandomState(2).randn(40, 5))
    path = str(tmp_path / "ck.npz")
    jcheckpoint.save(path, {"params": params, "scaler": jsc})
    with np.load(path) as f:
        assert len(f.files) == 9 + readout_bias
    model, sc = checkpoint.load_surrogate(path, device="cpu")
    assert (model.b_out is not None) == readout_bias
    assert len(model.w_ih) == 3 and model.w_out.dtype == torch.float64
    want = jax.tree.map(np.asarray, params)
    for g, w in zip(jax.tree.leaves(interop.lstm_params_to_numpy(model)),
                    jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(sc.scale.numpy(), np.asarray(jsc.scale))
    assert sc.scale.device.type == "cpu"
    # The generic loader fills any template of the saved structure.
    tree = checkpoint.load(path, {"params": want,
                                  "scaler": scalers.Scaler(0, 0)})
    assert isinstance(tree["scaler"], scalers.Scaler)
    np.testing.assert_array_equal(tree["params"]["layers"][2]["w_ih"],
                                  want["layers"][2]["w_ih"])


class _Pair(NamedTuple):
    b: object
    a: object


def test_torch_checkpoint_tree_order_matches_jax(tmp_path):
    """Leaf order of a mixed tree (sorted dict keys, lists, tuples,
    NamedTuple fields in field order, None) is jax.tree.flatten's, both
    ways."""
    rng = np.random.RandomState(3)
    tree = {"z": [rng.randn(2), (rng.randn(3), None)],
            "a": _Pair(b=rng.randn(1), a={"y": rng.randn(4), "x": rng.randn(5)}),
            "m": rng.randn(2, 2)}
    port_path, jax_path = str(tmp_path / "p.npz"), str(tmp_path / "j.npz")
    checkpoint.save(port_path, tree)
    jcheckpoint.save(jax_path, tree)
    for path in (port_path, jax_path):
        for loaded in (checkpoint.load(path, tree),
                       jcheckpoint.load(path, tree)):
            assert jax.tree.structure(loaded) == jax.tree.structure(tree)
            for g, w in zip(jax.tree.leaves(loaded), jax.tree.leaves(tree)):
                np.testing.assert_array_equal(np.asarray(g), w)
    assert isinstance(checkpoint.load(port_path, tree)["a"], _Pair)
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load(port_path, {"only": 0})
    checkpoint.save(port_path, {"w": rng.randn(3, 3), "v": rng.randn(2)})
    with pytest.raises(ValueError, match="surrogate checkpoint"):
        checkpoint.load_surrogate(port_path, device="cpu")


def test_torch_recorded_checkpoint_metrics_on_cpu():
    """The recorded surrogate through the port in float32 on the CPU: its
    test-split and teacher-forced shadow metrics equal the JAX package's
    (recomputed here) to 1e-5 and the pinned numbers to 1e-5."""
    model, sc = checkpoint.load_surrogate(str(RECORDED), device="cpu")
    assert (len(model.w_ih), model.w_hh[0].shape, model.w_out.shape) == \
        (3, (50, 200), (50, 4))
    assert model.b_out is not None and model.w_out.dtype == torch.float32
    results = [generate_data.load(str(
        REPO / "results_repro" / f"forging_mult_traj_process_noise_N_{h}.npz"))
        for h in config.SurrogateConfig().horizons]
    data = surrogate.prepare(results, 10, scaler=sc, dtype=torch.float32,
                             device="cpu")
    (x_tr, _), (x_va, _), (x_te, y_te) = data.train, data.val, data.test
    assert (len(x_tr), len(x_va), len(x_te)) == (72000, 24000, 24000)
    # The stored scaler is fit_maxabs of the 72,000 training rows.
    table = surrogate.flatten_datasets(results).astype(np.float64)
    np.testing.assert_allclose(
        sc.scale.numpy(), scalers.fit_maxabs(table[:72000]).scale.numpy(),
        rtol=1e-7)
    got = surrogate_eval.fidelity_metrics(model.infer(x_te), y_te)
    track = surrogate_eval.build_feature_track(results[0], sc, traj=0)
    shadow = surrogate_eval.fidelity_metrics(
        surrogate_eval.teacher_forced(model, track, 10),
        torch.cat([track[1:, :4], track[-1:, :4]]))

    like = _jax_like(50, 3)
    like["params"] = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  like["params"])
    jck = jcheckpoint.load(str(RECORDED), like)
    scaled = np.asarray(jck["scaler"].transform(jnp.asarray(table)))
    te = slice(96000, 120000)
    jx, jy = jdatasets.windows(scaled[te], scaled[te][:, :4], 10,
                               traj_len=300)
    want = jsurrogate_eval.fidelity_metrics(
        np.asarray(jlstm.apply(jck["params"], jnp.asarray(jx, jnp.float32))),
        jy.astype(np.float32))
    jtrack = jsurrogate_eval.build_feature_track(results[0], jck["scaler"],
                                                 traj=0)
    jshadow = jsurrogate_eval.fidelity_metrics(
        jsurrogate_eval.teacher_forced(jck["params"], jtrack, 10),
        np.vstack([jtrack[1:, :4], jtrack[-1:, :4]]))
    assert jsurrogate._flatten_datasets(results).shape == table.shape
    for port, jax_, pinned in ((got, want, chip_smoke.RECORDED_TEST),
                               (shadow, jshadow, chip_smoke.RECORDED_SHADOW)):
        for k, v in pinned.items():
            assert abs(port[k] - jax_[k]) <= 1e-5, (k, port[k], jax_[k])
            assert abs(port[k] - v) <= 1e-5, (k, port[k], v)
            assert abs(jax_[k] - v) <= 1e-6, (k, jax_[k], v)


def test_torch_recorded_checkpoint_loads_row_major():
    """The recorded file stores w_out column-major; the port's weights are
    row-major, as the kernel reads them."""
    with np.load(RECORDED) as f:
        assert not f["arr_7"].flags.c_contiguous
    model, _ = checkpoint.load_surrogate(str(RECORDED), device="cpu")
    assert all(p.is_contiguous() for p in model.parameters())


def _jax_controller_like():
    return {"params": dict.fromkeys(interop.FNN_KEYS, 0),
            "in_scaler": (0, 0), "out_scaler": (0, 0)}


def test_torch_controller_checkpoint_both_ways(tmp_path):
    """A controller saved by the port loads in the JAX package and the
    other way round, with the same nine leaves, treedef and meta."""
    params, _ = jfnn.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    jin = jscalers.fit_maxabs(np.random.RandomState(1).randn(30, 3))
    jout = jscalers.fit_maxabs(np.random.RandomState(2).randn(30, 1))
    jpath = str(tmp_path / "jax.npz")
    jcheckpoint.save(jpath, {"params": params,
                             "in_scaler": (jin.shift, jin.scale),
                             "out_scaler": (jout.shift, jout.scale)},
                     meta={"width_dim": 1, "pipeline": "supervised"})
    p, in_sc, out_sc, meta = checkpoint.load_controller(jpath, device="cpu")
    assert meta == {"width_dim": 1, "pipeline": "supervised"}
    for k, v in params.items():
        np.testing.assert_array_equal(p[k].numpy(), np.asarray(v))
    np.testing.assert_array_equal(in_sc.scale.numpy(), np.asarray(jin.scale))
    assert in_sc.scale.device.type == "cpu"
    ppath = str(tmp_path / "port.npz")
    checkpoint.save_controller(ppath, p, in_sc, out_sc)
    with open(jpath + ".meta.json") as a, open(ppath + ".meta.json") as b:
        assert a.read() == b.read()
    back = jcheckpoint.load(ppath, _jax_controller_like())
    want = jcheckpoint.load(jpath, _jax_controller_like())
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_torch_recorded_controller_loads_row_major():
    p, in_sc, out_sc, meta = checkpoint.load_controller(
        str(RECORDED_CONTROLLER), device="cpu")
    assert meta["pipeline"] == "supervised" and meta["width_dim"] == 1
    assert p["w_in"].shape == (3, 50) and p["w_out"].shape == (50, 1)
    assert all(v.is_contiguous() and v.dtype == torch.float32
               for v in p.values())
    with pytest.raises(ValueError, match="leaves"):
        checkpoint.load_controller(str(REPO / "results_repro" /
                                       "surrogate_params.npz"), device="cpu")


RECORDED_UNSUP = REPO / "results_repro" / "results" / \
    "NN_controller_unsupervised_N_10_noise.npz"
UNSUP_DATASET = REPO / "results_repro" / \
    "forging_mult_traj_process_noise_N_10.npz"


def _jax_recorded_unsupervised():
    """The JAX package's numbers for the recorded unsupervised controller
    (``chip_smoke.recorded_unsupervised_metrics`` computes the port's): the
    MPC loss of 15 training windows through the recorded surrogate in
    float32 and float64, the scaled test-split metrics, a noise-free float32
    closed loop of 2 x 300 steps on the "unsupervised" streams, and the
    surrogate's free-running drift along its first trajectory."""
    from forging_control_tpu.eval import metrics as jmetrics
    from forging_control_tpu.loop import closed_loop as jcl
    from forging_control_tpu.nn import mpc_loss as jmpc_loss
    from forging_control_tpu.pipelines import config as jconfig
    from forging_control_tpu.pipelines import generate_data as jgenerate_data
    from forging_control_tpu.pipelines import unsupervised as junsupervised
    from forging_control_tpu.refgen import streams as jstreams

    like = _jax_like(50, 3)
    like["params"] = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  like["params"])
    jck = jcheckpoint.load(str(RECORDED), like)
    surr, state_sc = jck["params"], jck["scaler"]
    tree = jcheckpoint.load(str(RECORDED_UNSUP), _jax_controller_like())
    p = jax.tree.map(jnp.asarray, tree["params"])
    in_sc = jscalers.Scaler(*map(jnp.asarray, tree["in_scaler"]))
    u_sc = jscalers.Scaler(*map(jnp.asarray, tree["out_scaler"]))
    res = jgenerate_data.load(str(UNSUP_DATASET))
    (xtr, _, ztr), _, (xte, ute, _), _, _ = junsupervised.prepare_data(
        res, state_sc, jconfig.UnsupervisedConfig())
    out = {}
    for name, dt in (("mpc_loss_f32", jnp.float32),
                     ("mpc_loss_f64", jnp.float64)):
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dt), t)  # noqa
        xb, zb = cast(xtr[:15]), cast(ztr[:15])
        pp = cast(p)
        out[name] = float(jmpc_loss.mpc_loss(
            pp, cast(surr), xb, jfnn.apply(pp, xb), zb, horizon=10)[0])
    pred = jfnn.apply(p, jnp.asarray(xte))
    out["test"] = {k: float(f(jnp.asarray(ute), pred)) for k, f in (
        ("MAE", jmetrics.mae), ("RMSE", jmetrics.rmse), ("R2", jmetrics.r2))}
    refs = jnp.asarray(jstreams.reference_table(2, "unsupervised", 300),
                       jnp.float32)
    x0 = jnp.tile(jnp.asarray(jcl.press.X0_REFERENCE, jnp.float32), (2, 1))
    ctrl = jcl.FunctionController(jfnn.make_policy(p, in_sc, u_sc))
    loop = jcl.LoopConfig(t_steps=300, variant="smooth")
    _, tel = jax.jit(lambda x, r, k: jcl.run_batch(loop, ctrl, x, r, k))(
        x0, refs, jax.random.PRNGKey(1))
    m = {k: float(v) for k, v in jmetrics.tracking_metrics(
        jnp.asarray(np.asarray(tel.ref).ravel()),
        jnp.asarray(np.asarray(tel.x[..., 1]).ravel())).items()}
    m["Command"] = float(np.abs(np.asarray(tel.u)).mean())
    out["loop"] = m
    track = jsurrogate_eval.build_feature_track(tel, state_sc, traj=0)
    preds = jsurrogate_eval.free_running(surr, track, 10)
    out["drift"] = {k: v for k, v in jsurrogate_eval.fidelity_metrics(
        preds[:-1], track[11:, :4]).items()}
    return out


def test_torch_recorded_unsupervised_metrics_on_cpu():
    """The recorded unsupervised controller (a checkpoint without
    ``width_dim``) through the port on the CPU: the numbers of
    ``chip_smoke.recorded_unsupervised_metrics`` equal the JAX package's
    (recomputed here) within the smoke run's bounds, and the JAX package's
    equal the pinned ``chip_smoke.RECORDED_UNSUP`` within 1e-6."""
    p, _, _, meta = checkpoint.load_controller(str(RECORDED_UNSUP),
                                               device="cpu")
    assert meta == {"width_dim": 1, "train_mode": "dagger",
                    "pipeline": "unsupervised"}
    results = generate_data.load(str(UNSUP_DATASET))
    got, launches, _ = chip_smoke.recorded_unsupervised_metrics(
        results, "cpu")
    want = _jax_recorded_unsupervised()
    pinned = chip_smoke.RECORDED_UNSUP
    for name, rtol in chip_smoke.UNSUP_LOSS_RTOL.items():
        assert abs(got[name] / want[name] - 1) <= rtol, name
        assert abs(want[name] / pinned[name] - 1) <= 1e-6, name
    for what in ("test", "loop", "drift"):
        assert got[what].keys() == want[what].keys() == pinned[what].keys()
        for k, v in pinned[what].items():
            tol = (chip_smoke.DRIFT_TOL[k.split("_")[0]] if what == "drift"
                   else chip_smoke.SUP_TOL[k])
            assert abs(got[what][k] - want[what][k]) <= tol, (what, k)
            assert abs(want[what][k] - v) <= 1e-6, (what, k)


def test_torch_compat_loads_reference_weights_and_scalers(tmp_path):
    """The reference's torch state dicts (FNNModel, LSTMModel; from a path
    and as a dict) and its four sklearn scaler kinds convert to the JAX
    package's values."""
    from forging_control_tpu.nn import torch_compat as jtorch_compat
    from forging_control_tpu_torch.nn import torch_compat
    from sklearn import preprocessing as sk
    rng = np.random.RandomState(0)
    fnn_sd = {"fc_inp.weight": torch.randn(50, 3), "fc_inp.bias":
              torch.randn(50), "fc_int.weight": torch.randn(50, 50),
              "fc_int.bias": torch.randn(50), "fc_out.weight":
              torch.randn(1, 50)}
    path = str(tmp_path / "fnn.pt")
    torch.save(fnn_sd, path)
    want = jtorch_compat.fnn_from_torch(fnn_sd)
    for source in (fnn_sd, path):
        got = torch_compat.fnn_from_torch(source, device="cpu")
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))
            assert got[k].is_contiguous()
    lstm_sd = {"fc.weight": torch.randn(4, 8), "fc.bias": torch.randn(4)}
    for l in range(2):
        lstm_sd[f"lstm.weight_ih_l{l}"] = torch.randn(32, 5 if l == 0 else 8)
        lstm_sd[f"lstm.weight_hh_l{l}"] = torch.randn(32, 8)
    model = torch_compat.lstm_from_torch(lstm_sd, num_layers=2, device="cpu")
    jparams = jtorch_compat.lstm_from_torch(lstm_sd, num_layers=2)
    got = interop.lstm_params_to_numpy(model)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(g, np.asarray(w))
    x = rng.randn(40, 3) * [1.0, 50.0, 0.1]
    for cls in (sk.MaxAbsScaler, sk.MinMaxScaler, sk.StandardScaler,
                sk.RobustScaler):
        fitted = cls().fit(x)
        a = torch_compat.scaler_from_sklearn(fitted)
        b = jtorch_compat.scaler_from_sklearn(fitted)
        np.testing.assert_array_equal(a.shift.numpy(), np.asarray(b.shift))
        np.testing.assert_array_equal(a.scale.numpy(), np.asarray(b.scale))
        np.testing.assert_allclose(a.transform(torch.from_numpy(x)).numpy(),
                                   fitted.transform(x), rtol=1e-12,
                                   atol=1e-12)
    with pytest.raises(ValueError, match="unsupported"):
        torch_compat.scaler_from_sklearn(object())
