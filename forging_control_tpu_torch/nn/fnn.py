"""Feed-forward NN controller.

Port of ``forging_control_tpu/nn/fnn.py`` (the reference's ``FNNModel``,
``Supervised Learning/Functions.py:113-178``): input 3 ([y_dot, z, ref],
scaled) -> hidden 50 ReLU -> output 1, with the reference's quirks:

* Xavier-*normal* weight init, zero bias init;
* a single weight-shared intermediate layer applied ``width_dim - 1`` times;
* **no bias on the output layer**;
* Hardtanh output clamp to [-1, 1] (actuator saturation in scaled units).

The parameters are a dict of tensors in the JAX package's layout —
``w_in`` (3, H), ``b_in`` (H,), ``w_int`` (H, H), ``b_int`` (H,), ``w_out``
(H, 1) — so they carry across one to one (``interop.fnn_params_*``) and
``torch.optim`` trains them as they are.  :func:`make_policy` is the
explicit-batch closed-loop policy ``(x_meas (B, 5), ref (B,), u_prev (B,))
-> u (B,)``.  Operands of mixed dtypes are promoted, as JAX promotes them
(float32 weights with float64 data compute in float64).
"""

from __future__ import annotations

import math

import torch

from .. import dual as ad
from ..device import resolve_device


def init(generator: torch.Generator, input_dim=3, hidden_dim=50, output_dim=1,
         width_dim=1, *, dtype=torch.float32, device="cuda"):
    """Xavier-normal weights, zero biases, no output bias; returns
    ``(params, {"width_dim": width_dim})`` like the JAX package's ``init``.

    The weights are drawn from ``generator`` (on its own device) in the order
    w_in, w_int, w_out.  Not the JAX package's ``jax.random`` draws: parity
    runs carry the JAX weights across (``interop.fnn_params_from_numpy``)."""
    device = resolve_device(device)

    def xavier(fan_in, fan_out):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = torch.randn(fan_in, fan_out, generator=generator, dtype=dtype,
                        device=generator.device)
        return (w * std).to(device)

    params = {
        "w_in": xavier(input_dim, hidden_dim),
        "b_in": torch.zeros(hidden_dim, dtype=dtype, device=device),
        "w_int": xavier(hidden_dim, hidden_dim),
        "b_int": torch.zeros(hidden_dim, dtype=dtype, device=device),
        "w_out": xavier(hidden_dim, output_dim),
    }
    return params, {"width_dim": width_dim}


def _promoted(x, params):
    dt = torch.promote_types(x.dtype, params["w_in"].dtype)
    return x.to(dt), {k: v.to(dt) for k, v in params.items()}


def _forward(p, x, width_dim):
    h = torch.relu(x @ p["w_in"] + p["b_in"])
    for _ in range(width_dim - 1):       # weight-shared intermediate layer
        h = torch.relu(h @ p["w_int"] + p["b_int"])
    return ad.clip(h @ p["w_out"], -1.0, 1.0)         # nn.Hardtanh()


def apply(params, x, width_dim=1):
    """Forward pass; x (..., input_dim) -> (..., output_dim) in [-1, 1]."""
    x, p = _promoted(torch.as_tensor(x, device=params["w_in"].device), params)
    return _forward(p, x, width_dim)


def init_simulator(generator: torch.Generator, input_dim, hidden_dim,
                   output_dim, width_dim=1, bias=False, *,
                   dtype=torch.float32, device="cuda"):
    """The general-purpose ``FNNSimulator`` head (``Unsupervised Learning/
    Model_NN/Functions.py:186-249``): Tanh activations, bias-free by default,
    no output clamp, weight-shared intermediate layer; torch's default
    Linear init U(-1/sqrt(fan_in), 1/sqrt(fan_in)), drawn from
    ``generator`` (non-parity, like :func:`init`)."""
    device = resolve_device(device)

    def uniform(fan_in, *shape):
        bound = 1.0 / math.sqrt(fan_in)
        w = torch.empty(shape, dtype=dtype, device=generator.device)
        return w.uniform_(-bound, bound, generator=generator).to(device)

    params = {
        "w_in": uniform(input_dim, input_dim, hidden_dim),
        "w_int": uniform(hidden_dim, hidden_dim, hidden_dim),
        "w_out": uniform(hidden_dim, hidden_dim, output_dim),
    }
    if bias:
        params["b_in"] = uniform(input_dim, hidden_dim)
        params["b_int"] = uniform(hidden_dim, hidden_dim)
        params["b_out"] = uniform(hidden_dim, output_dim)
    return params, {"width_dim": width_dim}


def apply_simulator(params, x, width_dim=1):
    """Forward pass of the FNNSimulator head; no output constraint."""
    x, p = _promoted(torch.as_tensor(x, device=params["w_in"].device), params)

    def lin(name, h):
        out = h @ p[f"w_{name}"]
        b = p.get(f"b_{name}")
        return out if b is None else out + b

    h = torch.tanh(lin("in", x))
    for _ in range(width_dim - 1):       # weight-shared intermediate layer
        h = torch.tanh(lin("int", h))
    return lin("out", h)


def make_policy(params, in_scaler, out_scaler, width_dim=1, lb=None, ub=None,
                *, cache=True):
    """Batched closed-loop policy ``u = g(x_meas (B, 5), ref (B,), u_prev
    (B,)) -> (B,)``.

    Mirrors ``FeasibilityRecovery.NN_make_step`` (Supervised Learning/
    Functions.py:1014-1068): features [y_dot, z, ref] -> scale -> forward
    -> inverse-scale.  The only saturation is the Hardtanh in scaled units:
    the reference declares LB_U/UB_U = +-0.2 but never applies them to the
    NN output; pass lb/ub to opt into explicit saturation.

    The weights and scalers are cast to the state's dtype and device.  With
    ``cache`` (the steppers' form) the cast copies are made at the first
    call with that pair, detached, and kept for later calls, so a CPU
    stepper of a controller whose weights live on a card pays no copy per
    step.  ``cache=False`` reads the live ``params`` at every call, so a
    gradient flows back to them (training through the closed loop, as the
    JAX package's ``train_plant_in_loop`` does)."""
    tensors = {**params, "in_shift": in_scaler.shift,
               "in_scale": in_scaler.scale, "out_shift": out_scaler.shift,
               "out_scale": out_scaler.scale}
    copies = {}

    def cast(x_meas):
        return {k: torch.as_tensor(v).to(x_meas.device, x_meas.dtype)
                for k, v in tensors.items()}

    def policy(x_meas, ref, u_prev):
        if cache:
            key = (x_meas.device, x_meas.dtype)
            if key not in copies:
                copies[key] = {k: v.detach() for k, v in cast(x_meas).items()}
            p = copies[key]
        else:
            p = cast(x_meas)
        feats = torch.stack([x_meas[:, 1], x_meas[:, 4], ref.to(x_meas)],
                            dim=-1)
        z = (feats - p["in_shift"]) / p["in_scale"]
        u_s = _forward(p, z, width_dim)[:, 0]
        u = u_s * p["out_scale"] + p["out_shift"]
        if lb is not None or ub is not None:
            u = ad.clip(u, lb, ub)
        return u

    return policy
