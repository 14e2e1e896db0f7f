"""State carried across between the JAX package and the port.

The MPC path has no learned weights: its "parameters" are the
configuration dataclasses and the solver warm-start state.  The surrogate
chain has the LSTM's weights and the feature scaler; the supervised chain
the FNN controller's weights and its two scalers.  The converters take
plain Python / NumPy data (``dataclasses.asdict`` of the JAX package's
objects, ``numpy.asarray`` of its arrays) and give it back, so this module
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .loop.closed_loop import LoopConfig, MPCController, Telemetry
from .nn.lstm import LSTMSurrogate
from .nn.scalers import Scaler
from .physics.press import PressParams
from .solver.riccati import ILQRState
from .solver.sqp import MPCConfig, SolverState

# The JAX package's MPCController.linsolve names -> the port's.
_LINSOLVE = {None: "kernel", "pallas": "kernel", "unrolled": "plain"}


def press_params_from_dict(d: dict) -> PressParams:
    return PressParams(**d)


def _with_params(cls, d: dict, tuples=()):
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - fields
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    kw = dict(d)
    if "params" in kw:
        kw["params"] = press_params_from_dict(kw["params"])
    for name in tuples:
        if kw.get(name) is not None:
            kw[name] = tuple(kw[name])
    return cls(**kw)


def mpc_config_from_dict(d: dict) -> MPCConfig:
    """``MPCConfig`` from ``dataclasses.asdict`` of the JAX package's."""
    return _with_params(MPCConfig, d, tuples=("step_ladder",))


def loop_config_from_dict(d: dict) -> LoopConfig:
    """``LoopConfig`` from ``dataclasses.asdict`` of the JAX package's."""
    return _with_params(LoopConfig, d,
                        tuples=("process_std", "meas_std", "state_clip"))


def linsolve_from_jax(name: str | None) -> str:
    """The port's ``linsolve`` for the JAX package's name: ``"pallas"`` and
    ``None`` map to ``"kernel"``, ``"unrolled"`` to ``"plain"``."""
    try:
        return _LINSOLVE[name]
    except KeyError:
        raise ValueError(f"unknown JAX linsolve {name!r}") from None


def mpc_controller_from_dict(d: dict) -> MPCController:
    """``MPCController`` from ``dataclasses.asdict`` of the JAX package's."""
    return MPCController(mpc_config_from_dict(d["cfg"]),
                         backend=d.get("backend", "sqp"),
                         linsolve=linsolve_from_jax(d.get("linsolve")))


def _tensor(a, dtype, device):
    # np.array copies: JAX hands out read-only buffers, and the tensor must
    # own writable memory.  Row-major, because JAX's arrays (and npz files
    # saved from them) may be column-major, and the kernels read row-major.
    return torch.as_tensor(np.array(a, order="C"), dtype=dtype,
                           device=resolve_device(device))


def solver_state_from_numpy(v, lam, *, dtype=None,
                            device="cuda") -> SolverState:
    """SQP warm start: ``v`` (..., N), ``lam`` (..., n_con)."""
    return SolverState(v=_tensor(v, dtype, device),
                       lam=_tensor(lam, dtype, device))


def ilqr_state_from_numpy(v, lam, *, dtype=None, device="cuda") -> ILQRState:
    """iLQR warm start: ``v`` (..., N), ``lam`` (..., N, nc)."""
    return ILQRState(v=_tensor(v, dtype, device),
                     lam=_tensor(lam, dtype, device))


def telemetry_to_numpy(telem: Telemetry) -> dict:
    """Telemetry as a dict of NumPy arrays; ``diag`` is a dict of its
    fields (``trace`` is None when it was not recorded)."""
    def np_(a):
        return None if a is None else a.detach().cpu().numpy()
    out = {k: np_(getattr(telem, k)) for k in Telemetry._fields if k != "diag"}
    out["diag"] = {k: np_(v) for k, v in telem.diag._asdict().items()}
    return out


def lstm_params_from_numpy(params: dict, *, dtype=None,
                           device="cuda") -> LSTMSurrogate:
    """The port's surrogate from the JAX package's LSTM params pytree
    (``{"layers": [{"w_ih", "w_hh"}, ...], "w_out"}`` and an optional
    ``"b_out"``) as NumPy arrays; ``dtype`` defaults to the arrays'."""
    def t(a):
        return _tensor(a, dtype, device)
    b_out = params.get("b_out")
    return LSTMSurrogate([t(l["w_ih"]) for l in params["layers"]],
                         [t(l["w_hh"]) for l in params["layers"]],
                         t(params["w_out"]),
                         None if b_out is None else t(b_out))


def lstm_params_to_numpy(model: LSTMSurrogate) -> dict:
    """The JAX package's LSTM params pytree, as NumPy arrays, of ``model``."""
    w_ih, w_hh, w_out, b_out = model.weights()

    def np_(p):
        return p.detach().cpu().numpy()
    out = {"layers": [{"w_ih": np_(a), "w_hh": np_(b)}
                      for a, b in zip(w_ih, w_hh)],
           "w_out": np_(w_out)}
    if b_out is not None:
        out["b_out"] = np_(b_out)
    return out


FNN_KEYS = ("b_in", "b_int", "w_in", "w_int", "w_out")


def fnn_params_from_numpy(params: dict, *, dtype=None, device="cuda") -> dict:
    """The port's FNN params (a dict of tensors in the same layout) from the
    JAX package's ``fnn.init`` pytree of NumPy arrays; ``dtype`` defaults
    to the arrays'."""
    return {k: _tensor(v, dtype, device) for k, v in params.items()}


def fnn_params_to_numpy(params: dict) -> dict:
    """The JAX package's FNN params pytree, as NumPy arrays."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def scaler_from_numpy(scaler, *, dtype=None, device="cuda") -> Scaler:
    """``Scaler`` from the JAX package's (shift, scale) pair of arrays."""
    shift, scale = scaler
    return Scaler(_tensor(shift, dtype, device), _tensor(scale, dtype, device))


def scaler_to_numpy(scaler: Scaler) -> tuple:
    """(shift, scale) as NumPy arrays, the JAX package's ``Scaler`` leaves."""
    return tuple(a.detach().cpu().numpy() for a in scaler)
