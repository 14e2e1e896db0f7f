"""LSTM plant surrogate.

Port of ``forging_control_tpu/nn/lstm.py`` (the reference's ``LSTMModel``,
``Unsupervised Learning/Model_NN/Functions.py:255-339``): stacked LSTM,
input 5 ([y_dot, p1, p2, z, u], scaled), hidden 50, 3 layers, no biases in
the cells, zero initial (h, c) per sequence, linear readout of the last
timestep (with the reference's optional bias) -> 4 next-step outputs.

The module's parameters keep the JAX package's layout — ``w_ih[l]``
(I_l, 4H), ``w_hh[l]`` (H, 4H), ``w_out`` (H, O), ``b_out`` (O) or None —
so weights carry across as a copy and the kernel reads them as they lie.
:meth:`LSTMSurrogate.forward` is the autograd path that training
differentiates; :meth:`LSTMSurrogate.infer` is the no-grad forward, which
runs kernel B2 on a card (``ops/lstm.py``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..device import resolve_device
from ..ops import lstm as lstm_ops


class LSTMSurrogate(nn.Module):
    """Stacked bias-free LSTM with a linear readout of the last timestep."""

    def __init__(self, w_ih, w_hh, w_out, b_out=None):
        super().__init__()
        self.w_ih = nn.ParameterList(w_ih)
        self.w_hh = nn.ParameterList(w_hh)
        self.w_out = nn.Parameter(w_out)
        self.b_out = None if b_out is None else nn.Parameter(b_out)

    def weights(self):
        return list(self.w_ih), list(self.w_hh), self.w_out, self.b_out

    def forward(self, x):
        """(..., T, I) -> (..., O), differentiable (the plain version)."""
        return lstm_ops.lstm_forward_torch(x, *self.weights())

    @torch.no_grad()
    def infer(self, x):
        """(..., T, I) -> (..., O) without gradients: the plain version on
        the CPU, kernel B2 on a card."""
        w_ih, w_hh, w_out, b_out = self.weights()
        return lstm_ops.lstm_forward(
            x, [w.detach() for w in w_ih], [w.detach() for w in w_hh],
            w_out.detach(), None if b_out is None else b_out.detach())


def init(generator: torch.Generator, input_dim=5, hidden_dim=50,
         num_layers=3, output_dim=4, *, dtype=torch.float32, device="cuda",
         readout_bias=True) -> LSTMSurrogate:
    """torch-default uniform(-1/sqrt(H), 1/sqrt(H)) init, drawn from
    ``generator`` (on its own device) in the order w_ih, w_hh per layer,
    w_out, b_out.  Not the JAX package's ``jax.random`` draws: parity runs
    carry the JAX weights across (``interop.lstm_params_from_numpy``)."""
    device = resolve_device(device)
    bound = 1.0 / math.sqrt(hidden_dim)

    def uniform(*shape):
        w = torch.empty(shape, dtype=dtype, device=generator.device)
        return w.uniform_(-bound, bound, generator=generator).to(device)

    w_ih, w_hh = [], []
    for l in range(num_layers):
        w_ih.append(uniform(input_dim if l == 0 else hidden_dim,
                            4 * hidden_dim))
        w_hh.append(uniform(hidden_dim, 4 * hidden_dim))
    w_out = uniform(hidden_dim, output_dim)
    b_out = uniform(output_dim) if readout_bias else None
    return LSTMSurrogate(w_ih, w_hh, w_out, b_out)
