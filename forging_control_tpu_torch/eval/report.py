"""Reporting: result tables and dataframe dumps.

A copy of ``forging_control_tpu/eval/report.py`` (NumPy code), kept in the
port so that it imports nothing of the JAX package; tensors are turned into
arrays at the boundary, and the files written are byte-identical to the JAX
package's for the same values.  It replicates the reference's artifacts:

* :func:`show_tabulate` — console table + single-row TSV under
  ``Tables/{Normal,Feasibility}/`` (``Supervised Learning/Functions.py:
  334-363``).
* :func:`dump_dataframe` — tab-separated 6-decimal trajectory dump like
  ``results/MPC_dataframe.txt`` (``Supervised Learning/Main.py:832-859``).
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def format_table(d: Mapping[str, float]) -> str:
    """fancy-grid-ish console rendering (no external tabulate dependency)."""
    keys = list(d)

    def fmt(v):
        try:
            return f"{float(v):.6g}"
        except (TypeError, ValueError):
            return str(v)

    vals = [fmt(d[k]) for k in keys]
    widths = [max(len(k), len(v)) for k, v in zip(keys, vals)]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    head = "|" + "|".join(f" {k:<{w}} " for k, w in zip(keys, widths)) + "|"
    row = "|" + "|".join(f" {v:<{w}} " for v, w in zip(vals, widths)) + "|"
    return "\n".join([sep, head, sep, row, sep])


def show_tabulate(d: Mapping[str, float], file: str | None = None,
                  echo: bool = True) -> str:
    """Write the single-row TSV the reference emits (tab-separated header +
    one value row) and optionally print the table."""
    text = format_table(d)
    if echo:
        print(text)
    if file:
        os.makedirs(os.path.dirname(file), exist_ok=True)

        def fmt(v):
            # Numeric columns render as floats (reference format); label
            # columns (e.g. Time_impl: "native_cpp_sqp") pass through.
            try:
                return f"{float(v)}"
            except (TypeError, ValueError):
                return str(v)

        with open(file, "w") as f:
            f.write("\t".join(d.keys()) + "\n")
            f.write("\t".join(fmt(v) for v in d.values()) + "\n")
    return text


DATAFRAME_COLUMNS = ("time", "ref", "y", "y_dot", "p1", "p2", "z", "u")


def dump_dataframe(path: str, telem, dt: float = 1e-3) -> None:
    """Dump batched Telemetry as the reference's dataframe txt format:
    columns time/ref/y/y_dot/p1/p2/z/u, tab-separated, 6 decimals, rows
    concatenated across trajectories with per-trajectory time restarting
    at 0 (matches results/MPC_dataframe.txt)."""
    x = _np(telem.x)          # (B, T, 5)
    u = _np(telem.u)          # (B, T)
    ref = _np(telem.ref)      # (B, T)
    B, T = u.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write("\t".join(DATAFRAME_COLUMNS) + "\n")
        for b in range(B):
            for t in range(T):
                row = [t * dt, ref[b, t], x[b, t, 0], x[b, t, 1],
                       x[b, t, 2], x[b, t, 3], x[b, t, 4], u[b, t]]
                f.write("\t".join(f"{v:.6f}" for v in row) + "\n")


def load_dataframe(path: str) -> np.ndarray:
    return np.loadtxt(path, skiprows=1)
