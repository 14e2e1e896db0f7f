"""Evaluation metrics.

Port of ``forging_control_tpu/eval/metrics.py`` (the reference's metric
set, ``Supervised Learning/Functions.py:493-560``): MAE / RMSE / R2 with
sklearn semantics, mean-|u| command effort, and latency percentiles.  The
reductions take tensors (or arrays, as CPU tensors) and return 0-d tensors
in the inputs' promoted dtype; ``latency_stats`` is NumPy.
"""

from __future__ import annotations

import numpy as np
import torch


def mae(truth, pred):
    return torch.mean(torch.abs(torch.as_tensor(truth) - torch.as_tensor(pred)))


def rmse(truth, pred):
    d = torch.as_tensor(truth) - torch.as_tensor(pred)
    return torch.sqrt(torch.mean(d ** 2))


def r2(truth, pred):
    """Coefficient of determination, sklearn ``r2_score`` semantics."""
    truth = torch.as_tensor(truth)
    ss_res = torch.sum((truth - torch.as_tensor(pred)) ** 2)
    ss_tot = torch.sum((truth - torch.mean(truth)) ** 2)
    return 1.0 - ss_res / ss_tot


def tracking_metrics(ref, y_dot):
    """Closed-loop speed-tracking metrics: truth = reference signal,
    prediction = achieved velocity (Supervised Learning/Functions.py:
    493-525)."""
    return {
        "MAE": mae(ref, y_dot),
        "RMSE": rmse(ref, y_dot),
        "R2": r2(ref, y_dot),
    }


def command_effort(u):
    """Mean absolute command (Supervised Learning/Functions.py:528-543)."""
    return torch.mean(torch.abs(torch.as_tensor(u)))


def latency_stats(times_s):
    """Per-step latency stats in ms: mean/std/median/p25/p75.

    Keys match the reference's table headers exactly
    (``Supervised Learning/Functions.py:546-560``; e.g.
    ``Tables/Normal/MPC_results_N_10.csv``)."""
    t = np.asarray(times_s) * 1e3
    return {
        "Mean_time": float(t.mean()),
        "Std_time": float(t.std()),
        "Median_time": float(np.percentile(t, 50)),
        "25_perc": float(np.percentile(t, 25)),
        "75_perc": float(np.percentile(t, 75)),
    }
