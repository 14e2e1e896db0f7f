"""State/input scaling used inside the solver.

Port of ``forging_control_tpu/physics/scaling.py``: the reference MPC
formulates its NLP in scaled variables (y 0.1, y_dot 0.1, p1/p2 1e7,
z 0.01, u 0.01), which keeps every solver quantity O(1).
"""

from __future__ import annotations

import numpy as np
import torch

X_SCALE = np.array([0.1, 0.1, 1e7, 1e7, 0.01])
U_SCALE = 0.01

# Feasibility-recovery NLP scaling (Supervised Learning/Main.py:541-548).
FEAS_U_SCALE = 0.2
FEAS_X_SCALE = np.array([0.02, 0.4, 32e6, 32e6, 0.15])


def _x_scale(x: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(X_SCALE, dtype=x.dtype, device=x.device)


def scale_x(x):
    return x / _x_scale(x)


def unscale_x(xs):
    return xs * _x_scale(xs)


def scale_u(u):
    return u / U_SCALE


def unscale_u(us):
    return us * U_SCALE
