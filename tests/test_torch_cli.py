"""The port's CLI (``python -m forging_control_tpu_torch``) and dataset
generation, on the CPU: the ``surrogate`` and ``supervised`` subcommands on
tiny npz files log one finite JSON line (``supervised`` with the JAX
CLI's keys, and without ``--device`` it refuses to run on the CPU; the
subcommands of the unsupervised chain are in
``test_torch_cli_unsupervised.py``); both packages' CLIs write that line
to standard error and not to standard output;
``generate_data.run`` with noise off against the JAX package's (float64);
configs, datasets and do-mpc pickles (``generate --export-pkl``) move
between the two packages.

The CLI logs its line through the package logger, whose stream handler
holds the standard error of the moment it was made, so the tests read the
line from the records that reach the root logger (``caplog``)."""

import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu import cli as jcli
from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import generate_data as jgenerate_data
from forging_control_tpu.utils import dompc_pickle as jdompc_pickle
from forging_control_tpu_torch import cli
from forging_control_tpu_torch.pipelines import config, generate_data
from forging_control_tpu_torch.pipelines import surrogate
from forging_control_tpu_torch.utils import checkpoint


def _write_tiny(root):
    """Two horizon files of 2 trajectories x 300 steps; returns their
    paths in sorted(glob) order (N_10 before N_5)."""
    rng = np.random.RandomState(0)
    t = np.arange(300) / 300.0
    paths = []
    for h in (5, 10):
        r = {k: (np.sin(2 * np.pi * (i + h) * t)[None]
                 + 0.05 * rng.randn(2, 300)).astype(np.float32)
             for i, k in enumerate(("y", "y_dot", "p1", "p2", "z", "u"))}
        path = generate_data.dataset_path(str(root), h)
        generate_data.save(r, path)
        paths.append(path)
    return sorted(paths)


REPO = Path(__file__).resolve().parents[1]


def _logged(caplog) -> list:
    """The JSON lines the port's CLI logged, in order."""
    return [json.loads(r.getMessage()) for r in caplog.records
            if r.name == "forging_control_tpu_torch"]


def _finite(rec):
    return all(math.isfinite(v) for part in rec.values() for v in part.values())


def test_torch_cli_surrogate_prints_one_json_line(tmp_path, caplog):
    paths = _write_tiny(tmp_path)
    assert paths[0].endswith("N_10.npz")
    ck = str(tmp_path / "ck.npz")
    cli.main(["surrogate", "--data", str(tmp_path / "*.npz"), "--epochs", "1",
              "--device", "cpu", "--save", ck])
    lines = _logged(caplog)
    assert len(lines) == 1
    rec = lines[0]
    assert set(rec) == {"test", "closed_loop"} and _finite(rec)
    # The files went in sorted(glob) order, and the first is the shadow's.
    results = [generate_data.load(p) for p in paths]
    art = surrogate.run(results, config.SurrogateConfig(epochs=1), seed=0,
                        eval_results=results[0], device="cpu")
    assert rec["closed_loop"] == art.closed_loop_metrics
    assert rec["test"]["MAE"] == art.test_metrics["MAE"]
    model, sc = checkpoint.load_surrogate(ck, device="cpu")
    for a, b in zip(model.parameters(), art.model.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("argv", [
    ["unsupervised", "--data", "x.npz", "--train-mode", "imitation"],
    ["supervised", "--data", "x.npz", "--train-mode", "plant"],
])
def test_torch_cli_refuses_what_is_not_ported(argv, capsys):
    """The train modes each subcommand does not have are refused as in the
    JAX CLI."""
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code != 0


def test_torch_cli_generate_writes_a_dataset(tmp_path, caplog):
    cli.main(["generate", "--n-traj", "1", "--t-traj", "2", "--horizon", "5",
              "--backend", "sqp", "--device", "cpu", "--out", str(tmp_path)])
    rec, = _logged(caplog)
    assert rec["dataset"] == generate_data.dataset_path(str(tmp_path), 5)
    assert rec["solves"] == 2 and math.isfinite(rec["MAE"])
    assert "dataset_pkl" not in rec
    loaded = jgenerate_data.load(rec["dataset"])   # the JAX package reads it
    assert loaded["u"].shape == (1, 2) and loaded["w"].shape == (1, 2, 5)
    # A do-mpc pickle that the JAX package writes loads in the port.
    pkl = str(tmp_path / "from_jax.pkl")
    jdompc_pickle.save(pkl, loaded)
    for k, v in generate_data.load(pkl).items():
        np.testing.assert_array_equal(v, np.asarray(loaded[k], np.float64))


def test_torch_cli_generate_exports_a_pickle(tmp_path, caplog):
    """``generate --export-pkl`` writes ``<dataset>.pkl`` beside the npz and
    names it in the record, as the JAX CLI does; the JAX package's loader
    reads it back to the saved dataset."""
    cli.main(["generate", "--n-traj", "2", "--t-traj", "2", "--horizon", "5",
              "--backend", "sqp", "--export-pkl", "--device", "cpu", "--out",
              str(tmp_path)])
    rec, = _logged(caplog)
    assert rec["dataset_pkl"] == rec["dataset"][:-4] + ".pkl"
    saved = generate_data.load(rec["dataset"])
    recs = jdompc_pickle.load(rec["dataset_pkl"])
    assert set(recs) == {"mpc", "simulator"}
    back = jdompc_pickle.to_results(recs["mpc"])
    assert set(back) == {"y", "y_dot", "p1", "p2", "z", "ref", "u", "F_d"}
    for k, v in back.items():
        assert v.shape == (2, 2), k
        np.testing.assert_array_equal(v, np.asarray(saved[k], np.float64))
    assert jgenerate_data.load(rec["dataset_pkl"]).keys() == back.keys()


def _run_cli(package, argv, cwd):
    env = dict(os.environ, FCT_CPU="1", PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "")
                       .split(os.pathsep) if p]))
    return subprocess.run([sys.executable, "-m", package] + argv, cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.mark.parametrize("package", ["forging_control_tpu",
                                     "forging_control_tpu_torch"])
def test_torch_cli_result_line_goes_to_stderr(package, tmp_path):
    """Both packages' CLIs, each in a process of its own, write their JSON
    result line to standard error and nothing of it to standard output."""
    data = _write_supervised(tmp_path)
    argv = ["supervised", "--data", data, "--no-training", "--no-eval",
            "--out", str(tmp_path / "out")]
    if package.endswith("_torch"):
        argv += ["--device", "cpu"]
    out = _run_cli(package, argv, tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [l for l in out.stderr.splitlines() if l.startswith("{")]
    assert len(lines) == 1
    assert list(json.loads(lines[-1])) == ["test", "mpc", "nn"]
    assert '"test"' not in out.stdout


def test_torch_generate_data_matches_jax():
    """Noise off, n_traj = 2, t_traj = 3, horizon 5 (the SQP backend by
    "auto"), float64: every column to the bounds of the closed-loop parity
    test."""
    _, want = jgenerate_data.run(
        jconfig.GenerateConfig(n_traj=2, t_traj=3, horizon=5), seed=0,
        dtype=jnp.float64)
    _, got = generate_data.run(config.GenerateConfig(n_traj=2, t_traj=3,
                                                     horizon=5),
                               seed=0, dtype=torch.float64, device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == want[k].shape, k
    np.testing.assert_array_equal(got["ref"], want["ref"])
    np.testing.assert_array_equal(got["w"], want["w"])
    np.testing.assert_array_equal(got["iter"], want["iter"])
    np.testing.assert_allclose(got["u"], want["u"], rtol=1e-10, atol=1e-12)
    for k in ("y", "y_dot", "z"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9)
    for k in ("p1", "p2", "F_d"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-6)
    np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got["inf_du"], want["inf_du"], rtol=1e-7,
                               atol=1e-12)
    np.testing.assert_allclose(got["inf_pr"], want["inf_pr"], rtol=1e-7,
                               atol=1e-9)
    summ, jsumm = (generate_data.summarize(got),
                   jgenerate_data.summarize(want))
    assert summ.keys() == jsumm.keys()
    for k in jsumm:
        np.testing.assert_allclose(summ[k], jsumm[k], rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("name", ["GenerateConfig", "SurrogateConfig",
                                  "SupervisedConfig", "UnsupervisedConfig"])
def test_torch_config_round_trips_with_jax(name, tmp_path):
    cfg = getattr(config, name)(flags=config.Flags(enable_noise=True))
    path = str(tmp_path / "cfg.json")
    config.save_config(path, cfg)
    back = jconfig.load_config(path)
    assert dataclasses.asdict(back) == dataclasses.asdict(cfg)
    jconfig.save_config(path, back)
    assert config.load_config(path) == cfg


def _write_supervised(root):
    """A tiny dataset of 4 trajectories x 50 steps (200 rows, 120 of them
    for training)."""
    rng = np.random.RandomState(1)
    t = np.arange(50) / 50.0
    r = {k: (np.sin(2 * np.pi * (i + 1) * t)[None] * 0.3
             + 0.02 * rng.randn(4, 50)).astype(np.float32)
         for i, k in enumerate(("y", "y_dot", "p1", "p2", "z", "ref", "u"))}
    path = generate_data.dataset_path(str(root), 10)
    generate_data.save(r, path)
    return path


def _numbers_finite(part):
    return all(math.isfinite(v) for v in part.values()
               if not isinstance(v, str))


@pytest.mark.parametrize("feasibility", [False, True])
def test_torch_cli_supervised_prints_one_json_line(feasibility, tmp_path,
                                                   caplog, monkeypatch):
    """The whole chain at horizon 5 on one evaluation trajectory of 3 steps
    (the config's t_traj and n_traj_eval cut in the test), 2 epochs, with
    the latency rows: one finite JSON line with the JAX CLI's keys, the
    MPC row's latency columns from the native runtime, the tables written
    under --out."""
    data = _write_supervised(tmp_path)
    monkeypatch.setattr(cli.pcfg, "SupervisedConfig", functools.partial(
        config.SupervisedConfig, t_traj=3, n_traj_eval=1))
    out = tmp_path / "out"
    cli.main(["supervised", "--data", data, "--epochs", "2", "--horizon", "5",
              "--device", "cpu", "--out", str(out)]
             + (["--feasibility"] if feasibility else []))
    lines = _logged(caplog)
    assert len(lines) == 1
    rec = lines[0]
    assert list(rec) == ["test", "mpc", "nn"]
    assert all(_numbers_finite(part) for part in rec.values())
    assert rec["mpc"]["Time_impl"] == "native_cpp_sqp"
    assert "Tunnel_time" not in rec["nn"]          # no card stepper on a CPU
    sub = "Feasibility" if feasibility else "Normal"
    assert (out / "Tables" / sub / "NN_results_N_5.csv").exists()


def test_torch_cli_supervised_keys_match_jax(tmp_path, caplog, monkeypatch):
    """--no-eval: the JAX CLI and the port's print the same keys, and the
    same test metrics from the same data (the initial weights differ: each
    package draws its own)."""
    data = _write_supervised(tmp_path)
    seen = []
    monkeypatch.setattr(jcli.log, "info", seen.append)
    jcli.main(["supervised", "--data", data, "--epochs", "1", "--no-eval",
               "--out", str(tmp_path / "j")])
    want = json.loads(seen[-1])
    cli.main(["supervised", "--data", data, "--epochs", "1", "--no-eval",
              "--device", "cpu", "--out", str(tmp_path / "p")])
    got, = _logged(caplog)
    assert list(got) == list(want) == ["test", "mpc", "nn"]
    assert got["mpc"] is None and got["nn"] is None
    assert list(got["test"]) == list(want["test"])
    assert _numbers_finite(got["test"])


def test_torch_cli_supervised_needs_a_card_unless_asked(tmp_path):
    """Without --device the chain runs on cuda: on a machine without a card
    it stops with resolve_device's error instead of running on the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would go there")
    data = _write_supervised(tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["supervised", "--data", data, "--epochs", "1", "--no-eval",
                  "--out", str(tmp_path / "p")])
