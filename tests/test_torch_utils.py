"""The port's ``utils`` against the JAX package's (CPU): logging, the timer,
notifications and the progress bar as ``tests/test_report_infra.py`` checks
the JAX package's; do-mpc pickles written by either package load in the
other to the same results dict (atol 0) and the two writers give the same
bytes; the ``torch.distributed.checkpoint`` round trip of ``save_orbax`` /
``load_orbax``; the solver's phase breakdown; and the profiler's trace."""

import io
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.pipelines import generate_data as jgenerate_data
from forging_control_tpu.utils import dompc_pickle as jdompc_pickle
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import fnn, scalers, train
from forging_control_tpu_torch.pipelines import generate_data
from forging_control_tpu_torch.solver import sqp
from forging_control_tpu_torch.utils import (checkpoint, dompc_pickle,
                                             notify, profiling, progress)
from forging_control_tpu_torch.utils.logging import get_logger
from forging_control_tpu_torch.utils.timer import Timer


def test_torch_logger_is_idempotent(tmp_path):
    """One console handler however often it is asked for, a file handler
    per file, and the records reach the root logger."""
    path = str(tmp_path / "run.log")
    log = get_logger("fct_torch_test_logger", log_file=path)
    assert get_logger("fct_torch_test_logger", log_file=path) is log
    kinds = [type(h) for h in log.handlers]
    assert kinds.count(logging.FileHandler) == 1
    assert kinds.count(logging.StreamHandler) == 1
    assert log.propagate and log.level == logging.INFO
    log.info("hello %s", "file")
    for h in log.handlers:
        h.flush()
    assert "INFO hello file" in open(path).read()
    assert get_logger().name == "forging_control_tpu_torch"


def test_torch_timer_stats():
    t = Timer()
    for _ in range(5):
        t.tic()
        t.toc()
    s = t.stats_ms()
    assert set(s) == {"Mean_time", "Std_time", "Median_time",
                      "25_perc", "75_perc"}
    assert len(t.times) == 5 and Timer().stats_ms() == {}


def test_torch_notify(tmp_path, caplog):
    """Logs the event through the package logger and appends a JSON line to
    the events file."""
    events = str(tmp_path / "events.jsonl")
    ev = notify.notify("Experiment over", "closed loop done",
                       events_file=events)
    assert ev["title"] == "Experiment over"
    rec = json.loads(open(events).read().strip())
    assert rec["message"] == "closed loop done" and "ts" in rec
    assert "NOTIFY Experiment over: closed loop done" in caplog.messages


def test_torch_progress_bar_non_tty():
    """Plain lines off a TTY; ``epoch_log_fn`` plugs into the port's
    trainers' ``log_fn`` hook."""
    buf = io.StringIO()
    bar = progress.ProgressBar(total=4, label="t", stream=buf,
                               min_interval_s=0.0)
    for _ in range(4):
        bar.update()
    bar.close()
    assert "4/4 (100%)" in buf.getvalue()

    buf2 = io.StringIO()
    params = fnn.init(torch.Generator().manual_seed(0), hidden_dim=8,
                      dtype=torch.float64, device="cpu")[0]
    x = torch.rand(32, 3, dtype=torch.float64)
    _, rep = train.train_supervised(
        params, x, x[:, :1], x, x[:, :1], epochs=2, batch_size=16,
        log_fn=progress.epoch_log_fn(2, label="fnn", stream=buf2))
    lines = buf2.getvalue().splitlines()
    assert lines[0].startswith("fnn 1/2 (50%)")
    assert lines[1].startswith("fnn 2/2 (100%)")
    assert f"loss {rep.train_losses[1]:.5f}" in lines[1]


def _results(seed=0, n=3, t=50):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=(n, t)) for k in
            ("y", "y_dot", "p1", "p2", "z", "ref", "u", "F_d")}


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torch_dompc_pickle_round_trips_with_jax(writer, tmp_path):
    """A pickle that either package writes loads in both to the same
    records and the identical results dict (atol 0), and reads as a
    dataset through either ``generate_data.load``."""
    results = _results()
    path = str(tmp_path / "forging_test_N_10.pkl")
    (jdompc_pickle if writer == "jax" else dompc_pickle).save(path, results)
    recs, jrecs = dompc_pickle.load(path), jdompc_pickle.load(path)
    assert set(recs) == set(jrecs) == {"mpc", "simulator"}
    for key in recs:
        assert recs[key].keys() == jrecs[key].keys()
        for f in recs[key]:
            np.testing.assert_array_equal(recs[key][f], jrecs[key][f])
    assert recs["mpc"]["_x"].shape == (150, 5)
    tcol = recs["mpc"]["_time"][:, 0]
    assert tcol[0] == 0.0 and tcol[50] == 0.0 and tcol[1] == 1e-3
    for back in (dompc_pickle.to_results(recs["mpc"], t_traj=50),
                 jdompc_pickle.to_results(jrecs["mpc"], t_traj=50),
                 generate_data.load(path), jgenerate_data.load(path)):
        assert back.keys() == results.keys()
        for k in results:
            np.testing.assert_allclose(back[k], results[k], rtol=0, atol=0)


def test_torch_dompc_pickle_writers_match_bytes(tmp_path):
    """The two writers emit the same bytes (one do_mpc.data stand-in in the
    process), also from float32 and tensor inputs and without F_d."""
    results = _results(1, n=2, t=7)
    results["u"] = results["u"].astype(np.float32)
    del results["F_d"]
    mine = {k: torch.from_numpy(v) for k, v in results.items()}
    paths = [str(tmp_path / f"{w}.pkl") for w in ("jax", "torch")]
    jdompc_pickle.save(paths[0], results)
    dompc_pickle.save(paths[1], mine)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and len(a) > 1000


def test_torch_checkpoint_orbax_roundtrip(tmp_path):
    """``save_orbax``/``load_orbax`` (a dcp directory) round-trip an FNN
    and a scaler into a template's structure, and ``load_meta`` reads its
    sidecar, as the JAX package's orbax pair does."""
    params = fnn.init(torch.Generator().manual_seed(0), dtype=torch.float64,
                      device="cpu")[0]
    sc = scalers.Scaler(torch.zeros(3), torch.ones(3) * 2)
    tree = {"params": params, "scaler": sc, "table": np.arange(6.0)}
    path = str(tmp_path / "ckpt_dcp")
    checkpoint.save_orbax(path, tree, meta={"horizon": 10})
    like = {"params": {k: torch.zeros_like(v) for k, v in params.items()},
            "scaler": scalers.Scaler(torch.zeros(3), torch.zeros(3)),
            "table": np.zeros(6)}
    loaded = checkpoint.load_orbax(path, like)
    for k, v in params.items():
        assert torch.equal(loaded["params"][k], v)
    assert isinstance(loaded["scaler"], scalers.Scaler)
    np.testing.assert_array_equal(loaded["scaler"].scale.numpy(), 2.0)
    assert isinstance(loaded["table"], np.ndarray)
    np.testing.assert_array_equal(loaded["table"], np.arange(6.0))
    assert checkpoint.load_meta(path)["horizon"] == 10
    # The JAX package's FNN through the same path.
    jparams = jax.tree.map(np.asarray, jfnn.init(jax.random.PRNGKey(1),
                                                 dtype=jnp.float64)[0])
    checkpoint.save_orbax(path, jparams)
    back = checkpoint.load_orbax(path, interop.fnn_params_from_numpy(
        jparams, device="cpu"))
    for k in jparams:
        np.testing.assert_array_equal(back[k].numpy(), jparams[k])


def test_torch_solver_phase_breakdown():
    """All six phases present with positive times and op counts; the
    derivative phases dispatch more ops than their primal evaluations; on
    the CPU no kernel launches; the record is JSON-ready."""
    rec = profiling.solver_phase_breakdown(
        sqp.MPCConfig(horizon=5, gn_iters=2, al_iters=1), batch=8, reps=1,
        device="cpu")
    assert (rec["horizon"], rec["batch"], rec["backend"]) == (5, 8, "cpu")
    assert set(rec["phases"]) == {"f", "g", "grad_f", "jac_g", "linsolve",
                                  "total"}
    for name, ph in rec["phases"].items():
        assert ph["t_wall_s"] > 0 and ph["t_wall_per_solve_us"] > 0, name
        assert ph["ops"] > 0 and ph["chol_solve_launches"] == 0, name
    p = rec["phases"]
    assert p["grad_f"]["ops"] > p["f"]["ops"]
    assert p["jac_g"]["ops"] > p["g"]["ops"]
    assert p["total"]["fraction_of_total"] == 1.0
    json.dumps(rec)


def test_torch_profiler_trace_writes_log_dir(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiling.trace(log_dir) as d:
        with profiling.annotate("fct_region"):
            torch.ones(4).sum()
    assert d == log_dir
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert "fct_region" in open(os.path.join(log_dir, files[0])).read()
