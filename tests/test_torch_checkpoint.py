"""Checkpoints move between the JAX package and the port, and the recorded
surrogate checkpoint gives the JAX package's metrics through the port.

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
