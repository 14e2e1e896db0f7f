"""Differentiable MPC-inspired training loss.

Port of ``forging_control_tpu/nn/mpc_loss.py`` (the reference's
``MPCLoss``, ``Unsupervised Learning/Functions.py:1336-1472``): the FNN
controller and the LSTM plant surrogate are rolled out N steps from each
training window, accumulating per step

    cost = (y_dot_hat - ref)^2                       # tracking
         + alpha * (u_prev - u_next)^2               # command variation
         + relu(-p1_hat) + relu(-p2_hat)             # lower pressure bounds
         + relu(p1_hat - 2.122366)                   # upper bounds, scaled
         + relu(p2_hat - 1.036233)                   #   units (~32 MPa)

and the loss is the batch mean of (sum_k cost_k) / N.  Gradients flow
through all N x (FNN + LSTM) applications.  The surrogate runs its autograd
``LSTMSurrogate.forward`` (the plain version): the JAX package
differentiates its jnp LSTM here, never the Pallas kernel, which has no
VJP, and kernel B2 has none either.

Surrogate state layout (scaled): window (..., lookback, 5) over
[y_dot, p1, p2, z, u]; LSTM output (..., 4) = next [y_dot, p1, p2, z].
Dtypes follow the JAX package's promotion; the root step writes the
controller's command into the window in the window's dtype, as
``window.at[...].set`` does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fnn

P1_UB_SCALED = 2.122366   # Unsupervised Learning/Functions.py:1411
P2_UB_SCALED = 1.036233


class MPCLossOutputs(NamedTuple):
    """Per-sample decomposition matching the reference's loss_features dict
    (Functions.py:1469-1470)."""

    loss: torch.Tensor        # (B,)
    command: torch.Tensor     # (B,)
    error: torch.Tensor       # (B,)
    prediction: torch.Tensor  # (B, N) commands over the unroll


def _constraint_cost(x0):
    return (torch.relu(-x0[..., 1]) + torch.relu(-x0[..., 2])
            + torch.relu(x0[..., 1] - P1_UB_SCALED)
            + torch.relu(x0[..., 2] - P2_UB_SCALED))


def mpc_loss(controller_params, surrogate, x_ctrl, u_ctrl, window,
             horizon=10, alpha=20.0, width_dim=1, noise=None,
             noise_std=0.01, generator: torch.Generator | None = None):
    """Compute (scalar loss, MPCLossOutputs).

    Args:
      controller_params: FNN params (a dict of tensors; trainable).
      surrogate: the ``LSTMSurrogate`` (frozen in the reference run).
      x_ctrl: (B, 3) controller input [y_dot, z, ref], scaled.
      u_ctrl: (B, 1) controller output at the root step (computed by the
        caller so its gradient takes part, as in the JAX package).
      window: (B, lookback, 5) recurrent window [y_dot, p1, p2, z, u].
      noise: optional (N, B, 4) standard-normal draws, one per unrolled
        step; ``noise[k] * noise_std`` is added to the k-th surrogate
        prediction (the enable_noise path, Functions.py:1400-1402).  Parity
        runs pass the JAX package's ``jax.random.normal`` draws.
      generator: draws that noise instead (on its own device), when
        ``noise`` is not given.  Neither: no noise.
    """
    w_dtype = surrogate.w_out.dtype
    ref = x_ctrl[:, -1]
    if noise is None and generator is not None:
        noise = torch.randn(horizon, x_ctrl.shape[0], 4, generator=generator,
                            dtype=torch.promote_types(window.dtype, w_dtype),
                            device=generator.device)
    if noise is not None:
        noise = torch.as_tensor(noise).to(window.device)

    def predict(win, k):
        x0 = surrogate(win.to(torch.promote_types(win.dtype, w_dtype)))
        if noise is not None:
            x0 = x0 + noise[k].to(x0.dtype) * noise_std
        return x0

    # Root step: replace the window's last command with the controller output.
    win = window.clone()
    win[:, -1, -1] = u_ctrl[:, 0]
    x0 = predict(win, 0)
    command0 = alpha * torch.square(win[:, -2, -1] - win[:, -1, -1])
    error0 = torch.square(x0[:, 0] - ref)
    cost_acc = error0 + command0 + _constraint_cost(x0)
    cmd_acc, err_acc = command0, error0

    u_next, preds = u_ctrl, [u_ctrl]
    for k in range(1, horizon):
        x_in = torch.stack([x0[:, 0], x0[:, 3], ref.to(x0.dtype)], dim=1)
        u0 = u_next
        u_next = fnn.apply(controller_params, x_in, width_dim)
        x_next = torch.cat([x0, u_next.to(x0.dtype)], dim=1)[:, None, :]
        win = torch.cat([win[:, 1:, :].to(x_next.dtype), x_next], dim=1)
        x0 = predict(win, k)
        err = torch.square(x0[:, 0] - ref)
        cmd = alpha * torch.square(u0[:, 0] - u_next[:, 0])
        cost = err + cmd + _constraint_cost(x0)
        cost_acc, cmd_acc, err_acc = (cost_acc + cost, cmd_acc + cmd,
                                      err_acc + err)
        preds.append(u_next)

    loss_vec = cost_acc / horizon
    out = MPCLossOutputs(loss=loss_vec, command=cmd_acc / horizon,
                         error=err_acc / horizon,
                         prediction=torch.cat(preds, dim=1))
    return torch.mean(loss_vec), out
