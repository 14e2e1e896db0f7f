"""Trajectory/diagnostic figure builders (raster/PNG backend).

Port of ``forging_control_tpu/eval/plots.py`` (the reference's Plotly
subplot builder, ``Graphics.plot`` + ``TitleBrowserRenderer``,
``Supervised Learning/Functions.py:1403-1609``): line/markers/bar/v_line/
h_line panel specs, per-trajectory paging, and PNG export to
``results/Images/`` (``Functions.py:1557-1565``).  Rendering is
matplotlib-Agg, imported only inside :func:`render_matplotlib`: the package
and every path that draws nothing import without matplotlib, and a render
without it raises an ``ImportError`` that names it.  The interactive pages
are :mod:`eval.html_dash`.  Neither module is on the compute path.
Telemetry may hold NumPy arrays or the port's tensors (moved to the host).

Panel spec: a list of dicts
    {"title": str, "series": [
        {"y": array, "x": array|None, "label": str,
         "type": "line"|"markers"|"bar"}, ...],
     "v_lines": [x, ...], "h_lines": [y, ...]}
"""

from __future__ import annotations

import os
from typing import Sequence


def host(a):
    """A telemetry leaf as a NumPy array (a tensor is copied to the host)."""
    import numpy as np
    if hasattr(a, "detach"):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


def _telemetry_panels(telem, traj: int = 0):
    import numpy as np
    x = host(telem.x)[traj]
    u = host(telem.u)[traj]
    ref = host(telem.ref)[traj]
    t = np.arange(len(u)) * 1e-3
    return [
        {"title": "speed tracking", "series": [
            {"x": t, "y": ref, "label": "ref", "type": "line"},
            {"x": t, "y": x[:, 1], "label": "y_dot", "type": "line"}]},
        {"title": "pressures [Pa]", "series": [
            {"x": t, "y": x[:, 2], "label": "p1", "type": "line"},
            {"x": t, "y": x[:, 3], "label": "p2", "type": "line"}],
         "h_lines": [0.0, 32e6]},
        {"title": "command", "series": [
            {"x": t, "y": u, "label": "u", "type": "line"}],
         "h_lines": [-0.2, 0.2]},
        {"title": "displacement / spool", "series": [
            {"x": t, "y": x[:, 0], "label": "y", "type": "line"},
            {"x": t, "y": x[:, 4], "label": "z", "type": "line"}]},
    ]


def solver_panels(telem, traj: int = 0):
    """Optimizer-diagnostics page: the reference's six per-step panels
    (barrier mu / objective / regularization / iteration count / step norm
    / infeasibility, ``Generate Data/Main.py:211-262`` — the reference
    plots the LAST iteration's stats per step,
    ``Generate Data/Functions.py:366-372``), plus per-iteration
    convergence panels from ``Diagnostics.trace`` when the solver ran with
    ``record_trace=True`` — history the reference discards."""
    import numpy as np
    d = telem.diag
    t = np.arange(host(d.iters).shape[-1]) * 1e-3
    def tr(a):
        return host(a)[traj]
    panels = [
        {"title": "barrier / AL penalty mu", "series": [
            {"x": t, "y": tr(d.mu), "label": "mu", "type": "line"}]},
        {"title": "objective", "series": [
            {"x": t, "y": tr(d.obj), "label": "obj", "type": "line"}]},
        {"title": "regularization", "series": [
            {"x": t, "y": tr(d.reg), "label": "reg", "type": "line"}]},
        {"title": "iterations", "series": [
            {"x": t, "y": tr(d.iters), "label": "iters", "type": "bar"}]},
        {"title": "step norm / size", "series": [
            {"x": t, "y": tr(d.d_norm), "label": "d_norm", "type": "line"},
            {"x": t, "y": tr(d.alpha), "label": "alpha", "type": "line"}]},
        {"title": "infeasibilities", "series": [
            {"x": t, "y": tr(d.inf_pr), "label": "inf_pr", "type": "line"},
            {"x": t, "y": tr(d.inf_du), "label": "inf_du", "type": "line"}]},
    ]
    if getattr(d, "trace", None) is not None:
        from ..solver.sqp import TRACE_COLS
        trace = host(d.trace)[traj]                 # (T, n_iter, 6)
        it = np.arange(trace.shape[1])
        # Per-iteration convergence at the hardest step (most iterations)
        # and at the first step (cold transient).
        steps = {"first step": 0,
                 "hardest step": int(np.argmax(tr(d.iters)))}
        for name, k in steps.items():
            col = {c: trace[k, :, i] for i, c in enumerate(TRACE_COLS)}
            panels.append({
                "title": f"per-iteration convergence — {name} (t={k})",
                "series": [
                    {"x": it, "y": col["obj"], "label": "obj",
                     "type": "line"},
                    {"x": it, "y": col["inf_pr"], "label": "inf_pr",
                     "type": "line"},
                    {"x": it, "y": col["inf_du"], "label": "inf_du",
                     "type": "line"},
                    {"x": it, "y": col["d_norm"], "label": "d_norm",
                     "type": "line"}]})
    return panels


def render_matplotlib(panels: Sequence[dict], path: str | None = None,
                      title: str = ""):
    """Render a panel spec with matplotlib; returns the Figure."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("PNG rendering (eval/plots.py) needs matplotlib, "
                          "which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(panels)
    fig, axes = plt.subplots(n, 1, figsize=(10, 2.4 * n), sharex=True)
    if n == 1:
        axes = [axes]
    for ax, p in zip(axes, panels):
        for s in p.get("series", []):
            x = s.get("x")
            if s.get("type") == "bar":
                ax.bar(x, s["y"], label=s.get("label"), width=(x[1] - x[0])
                       if x is not None and len(x) > 1 else 0.8)
            elif s.get("type") == "markers":
                ax.plot(x, s["y"], ".", label=s.get("label"))
            else:
                ax.plot(x, s["y"], label=s.get("label"))
        for v in p.get("v_lines", []):
            ax.axvline(v, color="k", ls="--", lw=0.8)
        for h in p.get("h_lines", []):
            ax.axhline(h, color="r", ls=":", lw=0.8)
        ax.set_title(p.get("title", ""), fontsize=9)
        ax.legend(fontsize=7, loc="upper right")
    fig.suptitle(title)
    fig.tight_layout()
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fig.savefig(path, dpi=120)
    return fig


def plot_closed_loop(telem, traj: int = 0, path: str | None = None):
    return render_matplotlib(_telemetry_panels(telem, traj), path,
                             title=f"trajectory {traj}")


def plot_solver_diagnostics(telem, traj: int = 0, path: str | None = None):
    return render_matplotlib(solver_panels(telem, traj), path,
                             title=f"solver diagnostics, trajectory {traj}")
