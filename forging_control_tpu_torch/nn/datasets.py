"""Dataset construction — vectorized window/pair building.

A copy of ``forging_control_tpu/nn/datasets.py`` (NumPy only), kept in the
port so that it imports nothing of the JAX package; ``telemetry_to_table``
takes the port's tensor ``Telemetry``.

Replaces the reference's torch Dataset classes with precomputed arrays
(no per-item indexing; one gather builds every window):

* :func:`supervised_pairs` — ``SequenceDataset`` of the supervised run
  (``Supervised Learning/Functions.py:69-108``): features at step t,
  command target at step t.
* :func:`windows` — ``CreateDataset`` (``Unsupervised Learning/Model_NN/
  Functions.py:109-181``): per-index lookback window ending at t,
  front-padded by repeating row 0, target = value at t+1 (clamped at the
  end of the trajectory).
* :func:`unsupervised_triples` — the 3-tuple ``SequenceDataset``
  (``Unsupervised Learning/Functions.py:66-132``): static features at t,
  target at t+1, recurrent window ending at t.

Split follows the reference: 60/20/20 train/val/test, trajectory-ordered,
**no shuffle** (``Supervised Learning/Main.py:196-202``).
"""

from __future__ import annotations

import numpy as np


def window_indices(n: int, lookback: int) -> np.ndarray:
    """(n, lookback) gather indices: window ends at i, front-clamped to 0."""
    idx = np.arange(n)[:, None] + np.arange(-lookback + 1, 1)[None, :]
    return np.maximum(idx, 0)


def windows(features: np.ndarray, targets: np.ndarray, lookback: int,
            traj_len: int | None = None):
    """CreateDataset equivalent: (x[i] = features window ending at i,
    y[i] = targets[min(i+1, n-1)]).

    ``traj_len``: build windows per-trajectory (reference's
    ``get_individual_dataset`` slicing — no window straddles a reset)."""
    n = len(features)
    if traj_len is None or n <= traj_len:
        x = features[window_indices(n, lookback)]
        nxt = np.minimum(np.arange(n) + 1, n - 1)
        return x, targets[nxt]
    idx = np.arange(n)
    start = (idx // traj_len) * traj_len
    end = np.minimum(start + traj_len, n)
    win = np.maximum(idx[:, None] + np.arange(-lookback + 1, 1)[None, :],
                     start[:, None])
    return features[win], targets[np.minimum(idx + 1, end - 1)]


def supervised_pairs(features: np.ndarray, targets: np.ndarray):
    """Supervised SequenceDataset: same-step (x_t, u_t) pairs."""
    return features, targets


def unsupervised_triples(features, targets, recurrent, lookback: int,
                         traj_len: int | None = None):
    """(x_t, y_{t+1}, window_t) triples.

    ``traj_len``: when set, windows and next-step targets are built
    per-trajectory (blocks of ``traj_len`` rows), matching the reference's
    per-trajectory datasets (``Data.get_individual_dataset``,
    ``Unsupervised Learning/Main.py:270-273``) — a window never straddles
    a trajectory reset, and the last target of a trajectory repeats its
    own final command rather than peeking at the next trajectory."""
    n = len(features)
    if traj_len is None or n <= traj_len:
        z = recurrent[window_indices(n, lookback)]
        nxt = np.minimum(np.arange(n) + 1, n - 1)
        return features, targets[nxt], z
    idx = np.arange(n)
    start = (idx // traj_len) * traj_len
    end = np.minimum(start + traj_len, n)
    win = idx[:, None] + np.arange(-lookback + 1, 1)[None, :]
    win = np.maximum(win, start[:, None])
    nxt = np.minimum(idx + 1, end - 1)
    return features, targets[nxt], recurrent[win]


def split_603030(n: int):
    """60/20/20 trajectory-ordered split indices (no shuffle)."""
    i1 = int(n * 0.6)
    i2 = int(n * 0.8)
    return slice(0, i1), slice(i1, i2), slice(i2, n)


def resample_every(n: int, stride: int) -> np.ndarray:
    """Every-N-th subsampling used by the unsupervised run
    (``Unsupervised Learning/Main.py:282-309``)."""
    return np.arange(0, n, stride)


def telemetry_to_table(telem) -> dict:
    """Flatten batched closed-loop Telemetry into flat per-step columns,
    matching the pickled do-mpc result layout (states at step t, command
    applied at t, reference at t)."""
    def host(a):
        return a.detach().cpu().numpy().reshape(-1)
    x = telem.x.detach().cpu().numpy().reshape(-1, 5)
    return {
        "y": x[:, 0], "y_dot": x[:, 1], "p1": x[:, 2], "p2": x[:, 3],
        "z": x[:, 4],
        "u": host(telem.u), "ref": host(telem.ref), "Fd": host(telem.Fd),
    }


def append_prediction(table: dict, name: str, pred, *, shift: bool = False,
                      fill=None) -> dict:
    """Add an ``NN(name)`` prediction column to a results table
    (``Data.append_prediction``, Supervised Learning/Functions.py:301-331;
    the reference optionally shifts LSTM predictions by one step on append,
    Unsupervised Learning/Model_NN/Functions.py:469)."""
    col = np.asarray(pred).reshape(-1)
    if shift:
        col = shift_commands(col, fill=fill)
    table[f"NN({name})"] = col
    return table


def shift_commands(arr: np.ndarray, fill=None) -> np.ndarray:
    """Shift a command column by one step, filling the first entry
    (``Data.shift_commands``, Supervised Learning/Functions.py:240-268)."""
    out = np.empty_like(arr)
    out[1:] = arr[:-1]
    out[0] = arr[0] if fill is None else fill
    return out


def batch_iter(arrays, batch_size: int, *, key=None, drop_last=False):
    """Minimal DataLoader: yields tuples of batch slices; shuffles when a
    numpy RandomState-compatible ``key`` (seed int) is given."""
    n = len(arrays[0])
    order = np.arange(n)
    if key is not None:
        np.random.RandomState(key).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        sel = order[s:s + batch_size]
        yield tuple(a[sel] for a in arrays)
