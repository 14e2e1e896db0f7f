"""Fixed-step RK4 plant integrator.

Port of ``forging_control_tpu/integrate/rk4.py``: the plant's fastest
linearised mode (~360 rad/s) gives omega*h ~= 0.09 at 1 ms / 4 substeps,
well inside RK4's stability region.  The substep count is a Python int, so
the loop is unrolled; ``f`` may return tensors or duals
(:mod:`forging_control_tpu_torch.dual`), which is how the solvers
differentiate through the rollout.
"""

from __future__ import annotations

from typing import Callable


def rk4_step(f: Callable, x, u, dt: float, substeps: int = 4,
             disturbance=None):
    """Integrate dx/dt = f(x, u) + w over one control period.

    Args:
      f: RHS f(x, u) -> xdot, broadcasting over batch axes.
      x: state, shape (..., n).
      u: input held over the step (zero-order hold), shape (...,).
      dt: control period (e.g. 1 ms).
      substeps: RK4 substeps per period (the reference uses 4).
      disturbance: optional additive process noise w, constant over the
        step (do-mpc's ``make_step(u0, w0=...)`` semantics).

    Returns the state after ``dt``.
    """
    h = dt / substeps
    if disturbance is None:
        g = f
    else:
        def g(xx, uu):
            return f(xx, uu) + disturbance

    for _ in range(substeps):
        k1 = g(x, u)
        k2 = g(x + 0.5 * h * k1, u)
        k3 = g(x + 0.5 * h * k2, u)
        k4 = g(x + h * k3, u)
        x = x + (h / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return x


def make_stepper(f: Callable, dt: float, substeps: int = 4) -> Callable:
    """Bind f, dt and substeps into a ``step(x, u[, disturbance])``
    closure (``forging_control_tpu/integrate/rk4.py:56-62``)."""

    def step(x, u, disturbance=None):
        return rk4_step(f, x, u, dt, substeps=substeps,
                        disturbance=disturbance)

    return step
