"""The port's CLI on the CPU, the unsupervised chain's subcommands: on tiny
npz files ``unsupervised`` (all three train modes), ``supervised
--train-mode dagger`` and ``sweep`` log one finite JSON line each, with
the JAX CLI's keys, and ``--plots`` writes the dashboards and PNGs."""

import functools
import math
import os

import numpy as np
import pytest

from forging_control_tpu_torch import cli
from forging_control_tpu_torch.pipelines import config, generate_data
from forging_control_tpu_torch.utils import checkpoint
from test_torch_cli import _logged, _numbers_finite, _write_supervised


def _write_unsupervised(root):
    """4 trajectories x 40 steps with every column the chain reads."""
    rng = np.random.RandomState(2)
    t = np.arange(40) / 40.0
    scale = {"y": 0.05, "y_dot": 0.5, "p1": 1e7, "p2": 2e7, "z": 0.1,
             "ref": 0.5, "u": 0.2}
    r = {k: ((np.sin(2 * np.pi * (i + 1) * t)[None]
              + 0.05 * rng.randn(4, 40)) * scale[k]).astype(np.float32)
         for i, k in enumerate(scale)}
    path = generate_data.dataset_path(str(root), 3)
    generate_data.save(r, path)
    return path


@pytest.mark.parametrize("mode", ["surrogate", "plant", "dagger"])
def test_torch_cli_unsupervised_prints_one_json_line(mode, tmp_path, caplog,
                                                     monkeypatch):
    """Horizon 3, lookback 10, 1 surrogate epoch, the chain's loops cut to
    14 steps and its stages to one or two steps (the config and run cut in
    the test): one finite JSON line with the JAX CLI's keys, the tables and
    the checkpoint under --out; with --plots (dagger) the dashboards."""
    from forging_control_tpu_torch.pipelines import unsupervised
    data = _write_unsupervised(tmp_path)
    monkeypatch.setattr(cli.pcfg, "UnsupervisedConfig", functools.partial(
        config.UnsupervisedConfig, closed_loop_val_traj=2, plant_steps=1,
        plant_n_traj=2, plant_pretrain_epochs=1, dagger_rounds=2,
        dagger_n_traj=1, dagger_epochs=1))
    monkeypatch.setattr(unsupervised, "run", functools.partial(
        unsupervised.run, t_traj=14))
    out = tmp_path / "out"
    plots = ["--plots"] if mode == "dagger" else []
    cli.main(["unsupervised", "--data", data, "--epochs", "1", "--horizon",
              "3", "--surrogate-epochs", "1", "--train-mode", mode,
              "--device", "cpu", "--out", str(out)] + plots)
    lines = _logged(caplog)
    assert len(lines) == 1 + bool(plots)
    rec = lines[0]
    assert list(rec) == ["test", "nn", "surrogate_drift"]
    assert all(_numbers_finite(part) for part in rec.values())
    assert (out / "Unsupervised" / "Tables" / "Normal" /
            "NN_results_N_3.csv").exists()
    _, _, _, meta = checkpoint.load_controller(
        str(out / "results" / "NN_controller_unsupervised_N_3.npz"),
        device="cpu")
    assert meta["train_mode"] == mode
    if plots:
        for name in ("closed_loop.html", "solver.html", "closed_loop.png",
                     "solver.png"):
            assert (out / "Images" / f"NN_unsupervised_{name}").exists()


def test_torch_cli_supervised_dagger_prints_one_json_line(
        tmp_path, caplog, monkeypatch):
    """--train-mode dagger at horizon 5: 2 rounds of 1 epoch, one
    relabelling of 1 stream x 2 steps, evaluation of 2 steps."""
    data = _write_supervised(tmp_path)
    monkeypatch.setattr(cli.pcfg, "SupervisedConfig", functools.partial(
        config.SupervisedConfig, t_traj=2, n_traj_eval=1,
        latency_profile=False, dagger_rounds=2, dagger_n_traj=1,
        dagger_epochs=1))
    cli.main(["supervised", "--data", data, "--horizon", "5", "--train-mode",
              "dagger", "--device", "cpu", "--out", str(tmp_path / "out")])
    lines = _logged(caplog)
    assert len(lines) == 1
    rec = lines[0]
    assert list(rec) == ["test", "mpc", "nn"]
    assert all(_numbers_finite(part) for part in rec.values())


def test_torch_cli_sweep_and_generate_plots(tmp_path, caplog):
    """sweep writes one dataset per horizon and logs a line for each;
    generate --plots writes the MPC dashboards (with the solver trace)."""
    cli.main(["sweep", "--horizons", "5", "6", "--n-traj", "1", "--t-traj",
              "2", "--device", "cpu", "--out", str(tmp_path)])
    recs = _logged(caplog)
    assert [r["dataset"] for r in recs] == [
        generate_data.dataset_path(str(tmp_path), h) for h in (5, 6)]
    assert all(math.isfinite(r["MAE"]) for r in recs)
    cli.main(["generate", "--n-traj", "1", "--t-traj", "2", "--horizon", "5",
              "--trace", "--plots", "--device", "cpu", "--out",
              str(tmp_path / "g")])
    lines = _logged(caplog)[len(recs):]
    assert len(lines) == 2 and "dataset" in lines[0]
    paths = lines[1]["dashboards"]
    assert len(paths) == 4 and all(os.path.getsize(p) > 1000 for p in paths)
