"""Feature scalers.

Port of ``forging_control_tpu/nn/scalers.py`` (the reference's sklearn
scalers, ``Supervised Learning/Functions.py:204-237``; MaxAbs is what every
experiment uses).  A :class:`Scaler` holds tensors and applies on any
device; the ``fit_*`` functions are NumPy on the host, with sklearn's rule
that a zero scale becomes 1, and return CPU tensors of the data's dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Scaler(NamedTuple):
    """Affine scaler: transform(x) = (x - shift) / scale."""

    shift: torch.Tensor
    scale: torch.Tensor

    def transform(self, x):
        return (x - self.shift) / self.scale

    def inverse(self, xs):
        return xs * self.scale + self.shift


def _nonzero(s):
    # sklearn semantics: zero scales are replaced by 1
    return np.where(np.asarray(s) == 0, 1.0, s)


def _scaler(shift, scale) -> Scaler:
    return Scaler(torch.as_tensor(np.array(shift)),
                  torch.as_tensor(np.array(scale)))


def fit_maxabs(x) -> Scaler:
    x = np.asarray(x)
    scale = _nonzero(np.max(np.abs(x), axis=0))
    return _scaler(np.zeros_like(scale), scale)


def fit_minmax(x, feature_range=(0.0, 1.0)) -> Scaler:
    x = np.asarray(x)
    lo, hi = np.min(x, axis=0), np.max(x, axis=0)
    a, b = feature_range
    scale = _nonzero((hi - lo) / (b - a))
    return _scaler(lo - a * scale, scale)


def fit_standard(x) -> Scaler:
    x = np.asarray(x)
    return _scaler(np.mean(x, axis=0), _nonzero(np.std(x, axis=0)))


def fit_robust(x) -> Scaler:
    x = np.asarray(x)
    med = np.median(x, axis=0)
    q75, q25 = np.percentile(x, 75, axis=0), np.percentile(x, 25, axis=0)
    return _scaler(med, _nonzero(q75 - q25))


FITTERS = {
    "maxabs": fit_maxabs,
    "minmax": fit_minmax,
    "standard": fit_standard,
    "robust": fit_robust,
}


def fit(kind: str, x) -> Scaler:
    """get_scaler equivalent (Supervised Learning/Functions.py:204-237)."""
    return FITTERS[kind](x)
