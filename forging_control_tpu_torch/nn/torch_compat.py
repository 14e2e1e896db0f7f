"""Load the reference's trained torch weights and sklearn scalers.

Port of ``forging_control_tpu/nn/torch_compat.py``: a user of the
reference has ``results/*.pt`` state dicts (``Supervised Learning/
Main.py:280``, ``Unsupervised Learning/Model_NN/Main.py:242``) and pickled
sklearn scalers (``Supervised Learning/Main.py:230-231``).  These convert
them into the port's FNN params, ``LSTMSurrogate`` and ``Scaler`` (through
``interop``, in the JAX package's layout), so the shipped artifacts run
unchanged in the closed loop.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import interop
from .scalers import Scaler


def _state_dict(source):
    if isinstance(source, (str, bytes)):
        return torch.load(source, map_location="cpu", weights_only=True)
    return source


def _np(t):
    return t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)


def fnn_from_torch(source, *, dtype=torch.float32, device="cuda") -> dict:
    """FNNModel state_dict (or a path to one) -> the port's FNN params.

    Layout per the reference (``Supervised Learning/Functions.py:113-178``):
    ``fc_inp`` -> ``fc_int`` (one weight-shared intermediate layer) ->
    ``fc_out`` (no bias); torch's (out, in) weights are transposed.
    """
    sd = _state_dict(source)
    return interop.fnn_params_from_numpy({
        "w_in": _np(sd["fc_inp.weight"]).T,
        "b_in": _np(sd["fc_inp.bias"]),
        "w_int": _np(sd["fc_int.weight"]).T,
        "b_int": _np(sd["fc_int.bias"]),
        "w_out": _np(sd["fc_out.weight"]).T,
    }, dtype=dtype, device=device)


def lstm_from_torch(source, num_layers: int = 3, *, dtype=torch.float32,
                    device="cuda"):
    """LSTMModel state_dict (or a path to one) -> the port's
    ``LSTMSurrogate``.  The reference LSTM is bias-free in the cells but
    keeps the default bias on the linear readout
    (``Model_NN/Functions.py:286-289``); torch's gate order (i, f, g, o) is
    the port's."""
    sd = _state_dict(source)
    return interop.lstm_params_from_numpy({
        "layers": [{"w_ih": _np(sd[f"lstm.weight_ih_l{l}"]).T,
                    "w_hh": _np(sd[f"lstm.weight_hh_l{l}"]).T}
                   for l in range(num_layers)],
        "w_out": _np(sd["fc.weight"]).T,
        "b_out": _np(sd["fc.bias"]),
    }, dtype=dtype, device=device)


def scaler_from_sklearn(sk) -> Scaler:
    """Fitted sklearn scaler object -> the port's affine :class:`Scaler`
    (float64, on the CPU).  The four kinds the reference selects between
    (``Supervised Learning/Functions.py:204-237``): MaxAbsScaler,
    MinMaxScaler, StandardScaler, RobustScaler."""
    name = type(sk).__name__

    def t(a):
        return torch.as_tensor(np.array(a, dtype=float))

    if name == "MaxAbsScaler":
        return Scaler(t(np.zeros_like(np.asarray(sk.max_abs_, float))),
                      t(sk.scale_))
    if name == "MinMaxScaler":
        # sklearn: x * scale_ + min_  == (x - shift) / scale
        scale = 1.0 / np.asarray(sk.scale_, float)
        shift = -np.asarray(sk.min_, float) * scale
        return Scaler(t(shift), t(scale))
    if name == "StandardScaler":
        return Scaler(t(sk.mean_), t(sk.scale_))
    if name == "RobustScaler":
        return Scaler(t(sk.center_), t(sk.scale_))
    raise ValueError(f"unsupported sklearn scaler {name}")
