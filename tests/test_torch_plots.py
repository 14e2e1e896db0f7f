"""The port's dashboards and PNGs (CPU): the HTML pages are byte for byte
the JAX package's from the same arrays (closed-loop and solver pages, with
and without the per-iteration trace, the port's telemetry given as tensors);
the PNGs are written (the check of ``tests/test_report_infra.py``); without
matplotlib a render raises an ImportError that names it."""

import os
import sys

import numpy as np
import pytest
import torch

from forging_control_tpu.eval import html_dash as jhtml_dash
from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch.eval import html_dash, plots
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.solver import sqp


def _telems(trace: bool):
    """The same seeded float32 telemetry, as the port's (tensors) and the
    JAX package's (arrays)."""
    rng = np.random.RandomState(1)
    B, T = 3, 6
    x = (rng.randn(B, T, 5) * [0.05, 0.4, 1e7, 1e7, 0.1]).astype(np.float32)
    arrays = {k: rng.randn(B, T).astype(np.float32)
              for k in ("u", "ref", "Fd", "obj", "inf_pr", "inf_du", "reg",
                        "d_norm", "mu", "alpha")}
    iters = rng.randint(1, 10, (B, T)).astype(np.int32)
    tr = rng.randn(B, T, 4, 6).astype(np.float32) if trace else None
    names = ("obj", "inf_pr", "inf_du", "reg", "d_norm", "mu", "alpha")

    def build(Telemetry, Diagnostics, conv):
        diag = Diagnostics(iters=conv(iters), **{k: conv(arrays[k])
                                                 for k in names},
                           trace=None if tr is None else conv(tr))
        return Telemetry(x=conv(x), u=conv(arrays["u"]),
                         ref=conv(arrays["ref"]), Fd=conv(arrays["Fd"]),
                         w=conv(np.zeros_like(x)), diag=diag)

    return (build(cl.Telemetry, sqp.Diagnostics, torch.from_numpy),
            build(jcl.Telemetry, jsqp.Diagnostics, np.asarray))


@pytest.mark.parametrize("trace", [False, True])
def test_torch_dashboards_are_byte_identical(trace, tmp_path):
    telem, jtelem = _telems(trace)
    for fn, jfn, name in (
            (html_dash.dashboard_from_telemetry,
             jhtml_dash.dashboard_from_telemetry, "loop"),
            (html_dash.solver_dashboard_from_telemetry,
             jhtml_dash.solver_dashboard_from_telemetry, "solver")):
        port = fn(telem, str(tmp_path / "p" / f"{name}.html"), title=name,
                  max_traj=2)
        jax_ = jfn(jtelem, str(tmp_path / "j" / f"{name}.html"), title=name,
                   max_traj=2)
        with open(port, "rb") as a, open(jax_, "rb") as b:
            assert a.read() == b.read(), name
    panels = html_dash._jsonable([plots.solver_panels(telem, 0)])[0]
    assert len(panels) == (8 if trace else 6)


def test_torch_plots_render(tmp_path):
    telem, _ = _telems(True)
    p1 = str(tmp_path / "Images/closed_loop.png")
    p2 = str(tmp_path / "Images/solver.png")
    import matplotlib.pyplot as plt
    for fn, path in ((plots.plot_closed_loop, p1),
                     (plots.plot_solver_diagnostics, p2)):
        plt.close(fn(telem, 0, path))
    assert os.path.getsize(p1) > 1000 and os.path.getsize(p2) > 1000


def test_torch_plots_without_matplotlib_names_it(monkeypatch, tmp_path):
    telem, _ = _telems(False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_closed_loop(telem, 0, str(tmp_path / "x.png"))
    # The HTML pages need no matplotlib.
    assert os.path.exists(html_dash.dashboard_from_telemetry(
        telem, str(tmp_path / "x.html")))
