"""The port's supervised chain against the JAX package (CPU): reporting
files byte for byte, the recorded controller's metrics (pinned in
``chip_smoke.py`` as ``RECORDED_SUP_TEST`` and ``RECORDED_SUP_LOOP``), and
a tiny noise-free ``supervised.run`` in
float64 with the JAX package's initial weights and batch tables, with and
without feasibility recovery.

The tiny run is horizon 5, one evaluation trajectory of 6 control steps
(not the 30 of the first plan: an MPC step at N = 5 costs about 3 s of
eager CPU ops in the port, and a recovered NN step about 3.5 s, and each
closed loop runs twice), 2 epochs, ``latency_profile=False``.
"""

import dataclasses
import filecmp
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from forging_control_tpu.eval import metrics as jmetrics
from forging_control_tpu.eval import report as jreport
from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import generate_data as jgenerate_data
from forging_control_tpu.pipelines import supervised as jsupervised
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu.utils import checkpoint as jcheckpoint
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.eval import report
from forging_control_tpu_torch.loop.closed_loop import Telemetry
from forging_control_tpu_torch.nn import fnn, scalers
from forging_control_tpu_torch.pipelines import config, generate_data
from forging_control_tpu_torch.pipelines import supervised
from forging_control_tpu_torch.utils import checkpoint

REPO = Path(__file__).resolve().parents[1]
RECORDED = REPO / "results_repro" / "results" / \
    "NN_controller_N_10_process_noise.npz"
DATASET = REPO / "results_repro" / "forging_mult_traj_process_noise_N_10.npz"
TIMING = {"Mean_time", "Std_time", "Median_time", "25_perc", "75_perc",
          "Amortized_time", "Training_time", "Tunnel_time",
          "Jax_stepper_mean", "Jax_stepper_median"}


def test_torch_report_files_are_byte_identical(tmp_path, capsys):
    """show_tabulate and dump_dataframe write the JAX package's bytes for
    the same values (floats, a label column, float32 telemetry given as
    tensors to the port and arrays to the JAX package)."""
    rng = np.random.RandomState(0)
    table = {"MAE": 0.0579307936, "R2": np.float32(0.888), "Mean_time": 1e-5,
             "Time_impl": "native_cpp_sqp", "n": 3}
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    text = report.show_tabulate(table, str(port / "Tables" / "t.csv"))
    assert text == jreport.show_tabulate(table, str(jax_ / "Tables" /
                                                    "t.csv"))
    assert text in capsys.readouterr().out
    assert report.format_table(table) == jreport.format_table(table)
    x = (rng.randn(2, 7, 5) * [0.05, 0.4, 1e7, 1e7, 0.1]).astype(np.float32)
    u, ref = rng.randn(2, 7).astype(np.float32), rng.randn(2, 7)
    telem = Telemetry(x=torch.from_numpy(x), u=torch.from_numpy(u),
                      ref=torch.from_numpy(ref), Fd=None, w=None, diag=None)
    report.dump_dataframe(str(port / "df.txt"), telem)
    jreport.dump_dataframe(str(jax_ / "df.txt"),
                           jcl.Telemetry(x=x, u=u, ref=ref, Fd=None, w=None,
                                         diag=None))
    for name in ("Tables/t.csv", "df.txt"):
        assert filecmp.cmp(port / name, jax_ / name, shallow=False), name
    np.testing.assert_array_equal(report.load_dataframe(str(port / "df.txt")),
                                  jreport.load_dataframe(str(jax_ /
                                                             "df.txt")))


def _jax_controller_like():
    return {"params": dict.fromkeys(interop.FNN_KEYS, 0),
            "in_scaler": (0, 0), "out_scaler": (0, 0)}


@functools.lru_cache(maxsize=None)
def _jax_recorded():
    tree = jcheckpoint.load(str(RECORDED), _jax_controller_like())
    p = jax.tree.map(jnp.asarray, tree["params"])
    in_sc = jscalers.Scaler(*map(jnp.asarray, tree["in_scaler"]))
    out_sc = jscalers.Scaler(*map(jnp.asarray, tree["out_scaler"]))
    res = jgenerate_data.load(str(DATASET))
    _, _, (xte, yte), _, _ = jsupervised.prepare_data(
        res, jconfig.SupervisedConfig())
    pred = jfnn.apply(p, jnp.asarray(xte), 1)
    test = {k: float(f(jnp.asarray(yte), pred)) for k, f in (
        ("MAE", jmetrics.mae), ("RMSE", jmetrics.rmse), ("R2", jmetrics.r2))}
    refs = jnp.asarray(jstreams.reference_table(2, "supervised", 300),
                       jnp.float32)
    x0 = jnp.tile(jnp.asarray(jcl.press.X0_REFERENCE, jnp.float32), (2, 1))
    ctrl = jcl.FunctionController(jfnn.make_policy(p, in_sc, out_sc, 1))
    loop = jcl.LoopConfig(t_steps=300, variant="smooth")
    _, tel = jax.jit(lambda x, r, k: jcl.run_batch(loop, ctrl, x, r, k))(
        x0, refs, jax.random.PRNGKey(1))
    m = {k: float(v) for k, v in jmetrics.tracking_metrics(
        jnp.asarray(np.asarray(tel.ref).ravel()),
        jnp.asarray(np.asarray(tel.x[..., 1]).ravel())).items()}
    m["Command"] = float(np.abs(np.asarray(tel.u)).mean())
    return test, m


def test_torch_recorded_controller_metrics_on_cpu():
    """The recorded controller through the port on the CPU: its scaled
    test-split imitation metrics on the N = 10 dataset and a noise-free
    float32 closed loop of 2 x 300 steps equal the JAX package's
    (recomputed here) within the smoke run's tolerances, and the numbers
    pinned in chip_smoke.py within 1e-6."""
    want_test, want_loop = _jax_recorded()
    for got, pinned in ((want_test, chip_smoke.RECORDED_SUP_TEST),
                        (want_loop, chip_smoke.RECORDED_SUP_LOOP)):
        assert got.keys() == pinned.keys()
        for k in pinned:
            assert abs(got[k] - pinned[k]) <= 1e-6, (k, got[k], pinned[k])
    res = generate_data.load(str(DATASET))
    test, loop = chip_smoke.recorded_controller_metrics(
        str(RECORDED), res, torch.float32, "cpu")
    for got, want in ((test, want_test), (loop, want_loop)):
        for k, v in want.items():
            assert abs(got[k] - v) <= chip_smoke.SUP_TOL[k], (k, got[k], v)


def _dataset():
    rng = np.random.RandomState(3)
    t = np.arange(50) / 50.0
    out = {}
    for i, k in enumerate(("y_dot", "z", "ref", "u")):
        out[k] = (np.sin(2 * np.pi * (i + 1) * t + rng.rand())[None]
                  * rng.uniform(0.1, 0.5, (4, 1))
                  + 0.02 * rng.randn(4, 50)).astype(np.float32)
    return out


@pytest.mark.parametrize("feasibility", [False, True])
def test_torch_supervised_run_matches_jax(feasibility, tmp_path):
    """Horizon 5, one evaluation trajectory of 6 steps, 2 epochs of batch
    32 on 120 training rows, float64, no noise, latency_profile off: the
    test, MPC and NN metrics within 1e-8; the same tables (timing columns
    apart) and dataframes."""
    results = _dataset()
    kw = dict(horizon=5, n_traj_eval=1, t_traj=6, epochs=2, batch_size=32,
              latency_profile=False)
    jcfg = jconfig.SupervisedConfig(
        **kw, flags=jconfig.Flags(enable_feasibility=feasibility))
    want = jsupervised.run(results, jcfg, seed=0, out_dir=str(tmp_path / "j"),
                           dtype=jnp.float64)

    init, _ = jfnn.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    perms = [np.asarray(jtrain._epoch_perm(k, 120, 32))
             for k in jax.random.split(jax.random.PRNGKey(0), 2)]
    cfg = config.SupervisedConfig(
        **kw, flags=config.Flags(enable_feasibility=feasibility))
    art = supervised.run(results, cfg, seed=0, out_dir=str(tmp_path / "p"),
                         dtype=torch.float64, device="cpu",
                         init_params=jax.tree.map(np.asarray, init),
                         perms=perms)
    for got, ref in ((art.test_metrics, want.test_metrics),
                     (art.mpc_metrics, want.mpc_metrics),
                     (art.nn_metrics, want.nn_metrics)):
        assert list(got) == list(ref)
        for k in set(ref) - TIMING:
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-8, atol=1e-12,
                                       err_msg=k)
    np.testing.assert_allclose(art.train_report.train_losses,
                               want.train_report.train_losses, rtol=1e-8)
    assert np.ptp(art.nn_telem.u.numpy()) > 1e-4

    sub = "Feasibility" if feasibility else "Normal"
    for name in ("test", "MPC", "NN"):
        rel = f"Tables/{sub}/{name}_results_N_5.csv"
        lines = [(tmp_path / d / rel).read_text().splitlines()
                 for d in ("p", "j")]
        assert lines[0][0] == lines[1][0]                    # the header
        for key, a, b in zip(lines[0][0].split("\t"), lines[0][1].split("\t"),
                             lines[1][1].split("\t")):
            if key not in TIMING:
                np.testing.assert_allclose(float(a), float(b), rtol=1e-8)
    for name in ("MPC_dataframe.txt", "Supervised_dataframe.txt"):
        a, b = (report.load_dataframe(str(tmp_path / d / "results" / name))
                for d in ("p", "j"))
        assert a.shape == b.shape == (6, 8)
        np.testing.assert_allclose(a, b, rtol=1e-8, atol=2e-6)
    p, _, _, _ = checkpoint.load_controller(
        str(tmp_path / "p" / "results" / "NN_controller_N_5.npz"),
        device="cpu")
    for k, v in want.params.items():
        np.testing.assert_allclose(p[k].numpy(), np.asarray(v), rtol=1e-8,
                                   atol=1e-8)


def test_torch_supervised_run_without_training_or_eval():
    """Training off: the initial weights are evaluated and no losses are
    recorded, in either train mode; closed_loop_eval off: no loop
    metrics."""
    results = _dataset()
    cfg = config.SupervisedConfig(flags=config.Flags(enable_training=False))
    art = supervised.run(results, cfg, closed_loop_eval=False, device="cpu")
    assert art.train_report.train_losses == [] and art.mpc_metrics is None
    want, _ = fnn.init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(art.params[k], want[k]) for k in want)
    assert np.isfinite(art.test_metrics["MAE"])
    sc = scalers.fit_maxabs(np.stack([results["y_dot"].ravel()[:120],
                                      results["z"].ravel()[:120],
                                      results["ref"].ravel()[:120]], 1))
    assert torch.equal(art.in_scaler.scale, sc.scale)
    dag = supervised.run(results, dataclasses.replace(cfg,
                                                      train_mode="dagger"),
                         closed_loop_eval=False, device="cpu")
    assert dag.train_report.train_losses == []
    assert all(torch.equal(dag.params[k], want[k]) for k in want)
