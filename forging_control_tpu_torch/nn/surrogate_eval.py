"""Surrogate (LSTM) rollout evaluation.

Port of ``forging_control_tpu/nn/surrogate_eval.py``.  Two modes, matching
the reference:

* :func:`teacher_forced` — windows rebuilt each step from simulator truth
  plus the applied command, as in the Model_NN closed-loop shadow rollout
  (``Unsupervised Learning/Model_NN/Functions.py:1003-1019``): one window
  gather and one ``infer`` call (one kernel launch on a card).
* :func:`free_running` — the surrogate's own predictions fed back into the
  window (open-loop drift test, ``Unsupervised Learning/Functions.py:
  1195-1222``): one ``infer`` call per step at batch 1, the JAX package's
  ``lax.scan`` as a Python loop.

Surrogate feature layout (scaled): [y_dot, p1, p2, z, u]; outputs
[y_dot, p1, p2, z] at the next step.  Tracks are host (CPU) tensors; the
rollouts run on the model's device in its dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from ..eval import metrics as m
from . import datasets


def build_feature_track(telem_or_results, state_scaler, traj: int | None = None):
    """(T, 5) scaled surrogate features from a results dict (NumPy arrays)
    or the port's ``Telemetry``, as a CPU tensor in the promoted dtype of
    the data and the scaler."""
    if isinstance(telem_or_results, dict):
        r = telem_or_results
        sel = slice(None) if traj is None else traj
        cols = np.stack([np.asarray(r[k])[sel]
                         for k in ("y_dot", "p1", "p2", "z", "u")], axis=-1)
        cols = torch.from_numpy(cols)
    else:
        t = telem_or_results
        x = t.x.detach().cpu()
        u = t.u.detach().cpu()
        if traj is not None:
            x, u = x[traj], u[traj]
        cols = torch.cat([x[..., 1:5], u[..., None]], dim=-1)
    return state_scaler.transform(cols)


def _on_model(model, a):
    p = model.w_out
    return torch.as_tensor(a).to(p.device, p.dtype)


def teacher_forced(model, track, lookback: int = 10):
    """Predict every next step from truth windows; returns (T, 4) preds
    aligned so preds[t] estimates track[t+1, :4]."""
    idx = torch.from_numpy(datasets.window_indices(len(track), lookback))
    return model.infer(_on_model(model, track)[idx])


def free_running(model, track, lookback: int = 10):
    """Open-loop rollout: seed the window with the first ``lookback`` truth
    rows, then roll forward feeding predictions back, using the recorded
    command sequence.  Returns (T - lookback, 4) predictions aligned with
    track[lookback:, :4]."""
    track = _on_model(model, track)
    win = track[:lookback]
    preds = []
    for u_next in track[lookback:, -1:]:
        x_hat = model.infer(win[None])[0]
        win = torch.cat([win[1:], torch.cat([x_hat, u_next])[None]])
        preds.append(x_hat)
    if not preds:
        return track.new_zeros(0, track.shape[-1] - 1)
    return torch.stack(preds)


def fidelity_metrics(preds, truth) -> dict:
    """Per-state + overall MAE/RMSE/R2 (Model_NN/Main.py:250-281), on the
    host."""
    preds = torch.as_tensor(preds).detach().cpu()
    truth = torch.as_tensor(truth).detach().cpu()
    out = {}
    for i, n in enumerate(["y_dot", "p1", "p2", "z"]):
        out[f"MAE_{n}"] = float(m.mae(truth[:, i], preds[:, i]))
        out[f"R2_{n}"] = float(m.r2(truth[:, i], preds[:, i]))
    out["MAE"] = float(m.mae(truth, preds))
    out["RMSE"] = float(m.rmse(truth, preds))
    out["R2"] = float(m.r2(truth.ravel(), preds.ravel()))
    return out
