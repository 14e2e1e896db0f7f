"""LSTM plant-surrogate pipeline.

Port of ``forging_control_tpu/pipelines/surrogate.py`` (the reference's
``Unsupervised Learning/Model_NN/Main.py``): train the LSTM next-step
predictor on multi-horizon MPC datasets, report teacher-forced test
fidelity, then the closed-loop fidelity of a surrogate shadow rollout on
the MPC run's truth.  Every no-grad forward (validation per epoch, test
split, shadow) is one ``LSTMSurrogate.infer`` call: one launch of kernel B2
on a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import interop
from ..device import resolve_device
from ..nn import datasets, lstm, scalers, surrogate_eval, train
from .config import SurrogateConfig

SURROGATE_FEATURES = ("y_dot", "p1", "p2", "z", "u")
TRAJ_LEN = 300        # rows per trajectory in the reference datasets


@dataclasses.dataclass
class SurrogateArtifacts:
    model: lstm.LSTMSurrogate
    state_scaler: scalers.Scaler
    test_metrics: dict
    train_report: train.TrainReport
    closed_loop_metrics: dict | None = None


@dataclasses.dataclass
class SurrogateData:
    """The scaler fitted on the training split and the (x, y) windows of
    the three splits, on the device in the run's dtype."""

    scaler: scalers.Scaler
    train: tuple
    val: tuple
    test: tuple


def flatten_datasets(results_list):
    """Concatenate per-horizon result dicts into one flat (rows, 5) table
    (Model_NN/Main.py:104-128 concatenates all five horizon files)."""
    cols = {k: np.concatenate([np.asarray(r[k]).ravel() for r in results_list])
            for k in SURROGATE_FEATURES}
    return np.stack([cols[k] for k in SURROGATE_FEATURES], axis=1)


def prepare(results_list, lookback: int, *, scaler=None, dtype=torch.float32,
            device="cuda") -> SurrogateData:
    """Flatten, split 60/20/20 in order, fit MaxAbs on the training split
    (or use ``scaler``), scale, and build per-trajectory windows.

    Scaling runs in float64 on the host, and the windows are cast to
    ``dtype`` once, afterwards, and moved to the device once.  (The JAX
    pipeline scales through jnp, which is float64 under its tests' x64 and
    float32 on a TPU, and always casts the windows to float32.)"""
    device = resolve_device(device)
    table = flatten_datasets(results_list).astype(np.float64)
    tr, va, te = datasets.split_603030(len(table))
    sc = scalers.fit("maxabs", table[tr]) if scaler is None else scaler
    scaled = sc.transform(torch.from_numpy(table)).numpy()

    def windows_for(sl):
        x, y = datasets.windows(scaled[sl], scaled[sl][:, :4], lookback,
                                traj_len=TRAJ_LEN)
        return (torch.from_numpy(x).to(device, dtype),
                torch.from_numpy(y).to(device, dtype))

    return SurrogateData(sc, windows_for(tr), windows_for(va),
                         windows_for(te))


def run(results_list, cfg: SurrogateConfig = SurrogateConfig(), *,
        seed: int = 0, eval_results: dict | None = None, dtype=torch.float32,
        device="cuda", init_params: dict | None = None,
        perms=None) -> SurrogateArtifacts:
    """Train and evaluate the surrogate on ``device`` in ``dtype``.

    ``init_params``: the initial weights as the JAX package's params pytree
    of NumPy arrays (e.g. its ``lstm.init`` from ``PRNGKey(seed)``); by
    default they are drawn from a ``torch.Generator`` seeded with ``seed``.
    ``perms``: the per-epoch batch tables (see ``train.train_surrogate``).
    """
    device = resolve_device(device)
    data = prepare(results_list, cfg.lookback, dtype=dtype, device=device)
    if init_params is None:
        model = lstm.init(torch.Generator().manual_seed(seed),
                          hidden_dim=cfg.hidden_dim,
                          num_layers=cfg.num_layers, dtype=dtype,
                          device=device)
    else:
        model = interop.lstm_params_from_numpy(init_params, dtype=dtype,
                                               device=device)
    if cfg.flags.enable_training:
        model, rep = train.train_surrogate(
            model, *data.train, *data.val, lr=cfg.lr, epochs=cfg.epochs,
            batch_size=cfg.batch_size, seed=seed, perms=perms)
    else:
        rep = train.TrainReport()

    x_test, y_test = data.test
    test_metrics = surrogate_eval.fidelity_metrics(model.infer(x_test), y_test)
    test_metrics["Training_time"] = rep.wall_time_s

    art = SurrogateArtifacts(model, data.scaler, test_metrics, rep)

    if eval_results is not None:
        # Closed-loop shadow fidelity: teacher-forced windows from the MPC
        # run's truth (Model_NN/Main.py:357-414).
        track = surrogate_eval.build_feature_track(eval_results, data.scaler,
                                                   traj=0)
        preds_cl = surrogate_eval.teacher_forced(model, track, cfg.lookback)
        truth_next = torch.cat([track[1:, :4], track[-1:, :4]])
        art.closed_loop_metrics = surrogate_eval.fidelity_metrics(
            preds_cl, truth_next)
    return art
