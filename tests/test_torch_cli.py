"""The port's CLI (``python -m forging_control_tpu_torch``) and dataset
generation, on the CPU: the ``surrogate`` subcommand on tiny npz files
prints one finite JSON line; ``generate_data.run`` with noise off against
the JAX package's (float64); configs and datasets move between the two
packages."""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.pipelines import config as jconfig
from forging_control_tpu.pipelines import generate_data as jgenerate_data
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


def _finite(rec):
    return all(math.isfinite(v) for part in rec.values() for v in part.values())


def test_torch_cli_surrogate_prints_one_json_line(tmp_path, capsys):
    paths = _write_tiny(tmp_path)
    assert paths[0].endswith("N_10.npz")
    ck = str(tmp_path / "ck.npz")
    cli.main(["surrogate", "--data", str(tmp_path / "*.npz"), "--epochs", "1",
              "--device", "cpu", "--save", ck])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
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
    ["surrogate", "--data", "x.npz", "--plots"],
    ["generate", "--export-pkl"],
    ["supervised", "--data", "x.npz"],
])
def test_torch_cli_refuses_what_is_not_ported(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(argv + ["--device", "cpu"])
    assert e.value.code != 0


def test_torch_cli_generate_writes_a_dataset(tmp_path, capsys):
    cli.main(["generate", "--n-traj", "1", "--t-traj", "2", "--horizon", "5",
              "--backend", "sqp", "--device", "cpu", "--out", str(tmp_path)])
    rec = json.loads(capsys.readouterr().out.strip())
    assert rec["dataset"] == generate_data.dataset_path(str(tmp_path), 5)
    assert rec["solves"] == 2 and math.isfinite(rec["MAE"])
    loaded = jgenerate_data.load(rec["dataset"])   # the JAX package reads it
    assert loaded["u"].shape == (1, 2) and loaded["w"].shape == (1, 2, 5)
    with pytest.raises(NotImplementedError, match="Queue A 14"):
        generate_data.load(rec["dataset"][:-4] + ".pkl")


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
