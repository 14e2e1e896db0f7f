"""Checkpoints: the JAX package's ``.npz`` format, and directories.

Port of the ``.npz`` path of ``forging_control_tpu/utils/checkpoint.py``
(``:19-46``): a tree of arrays is saved as ``path`` (``np.savez_compressed``
of its leaves, ``arr_0``, ``arr_1``, ...) plus ``path.meta.json``.  Leaves
go in ``jax.tree.flatten``'s order — dict keys sorted, lists and tuples in
order, NamedTuples in field order, None holding no leaf — so a checkpoint
written by either package loads in the other: the npz path is the
interchange between the two packages.

:func:`save_orbax` / :func:`load_orbax` keep the JAX package's names for its
directory checkpoints (``:55-74``), whose orbax imports jax.  Here they
write and read ``torch.distributed.checkpoint``'s directory format, with the
same ``path.meta.json`` sidecar, so :func:`load_meta` reads either path.
Neither package reads the other's directories.  They run without a process
group; with one, every rank calls them and each writes its own part.

:func:`load_surrogate` reads a ``{"params": ..., "scaler": ...}`` surrogate
checkpoint (what ``surrogate --save`` writes) into the port's
``LSTMSurrogate`` and ``Scaler``, reading the layout from the leaves'
shapes.  :func:`save_controller` / :func:`load_controller` move the FNN
controller checkpoints that the supervised and unsupervised pipelines write
(``results/NN_controller_*.npz``: the params and both scalers, meta
``width_dim`` and ``pipeline``, or ``train_mode`` and ``pipeline``).
"""

from __future__ import annotations

import json
import os
import warnings

import numpy as np
import torch

from .. import interop


def _flatten(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _treedef(tree) -> str:
    """The tree's structure, written like ``str`` of a JAX treedef."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"'{k}': {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(_treedef(v) for v in tree) + ")"
    return "*"


def _numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(path: str, tree, meta: dict | None = None) -> None:
    """Save a tree of tensors or arrays to ``path`` (.npz) +
    ``path.meta.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, *[_numpy(leaf) for leaf in _flatten(tree)])
    with open(path + ".meta.json", "w") as f:
        json.dump({"treedef": f"PyTreeDef({_treedef(tree)})",
                   "meta": meta or {}}, f)


def _leaves(path: str) -> list:
    with np.load(path) as f:
        return [f[k] for k in f.files]


def load(path: str, like):
    """Load into the structure of ``like`` (the tree saved), as NumPy
    arrays."""
    arrs = _leaves(path)
    n = len(_flatten(like))
    if len(arrs) != n:
        raise ValueError(f"checkpoint has {len(arrs)} leaves, template has {n}")
    return _unflatten(like, iter(arrs))


def load_meta(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)["meta"]


def _dcp_state(leaves) -> dict:
    """The flat state dict of a tree's leaves, ``arr_0``, ``arr_1``, ... as
    in the npz path; NumPy leaves become CPU tensors, tensors stay where they
    are."""
    return {f"arr_{i}": (leaf.detach() if isinstance(leaf, torch.Tensor)
                         else torch.from_numpy(np.array(leaf)))
            for i, leaf in enumerate(leaves)}


def _dcp(fn, state, **kw):
    """``fn`` (``dcp.save`` or ``dcp.load``) of ``state``.  Without a process
    group dcp runs in this process alone, and a save replaces an existing
    checkpoint; both are meant here, so dcp's warnings that they happen are
    dropped."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is "
                                "disabled, unavailable or uninitialized")
        warnings.filterwarnings("ignore",
                                message="Detected an existing checkpoint")
        fn(state, **kw)


def save_orbax(path: str, tree, meta: dict | None = None) -> None:
    """Save a tree of tensors or arrays as a ``torch.distributed.checkpoint``
    directory at ``path``, plus ``path.meta.json`` (written by rank 0)."""
    import torch.distributed.checkpoint as dcp

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    # Overwrite an existing checkpoint, as the JAX package's (force=True).
    _dcp(dcp.save, _dcp_state(_flatten(tree)),
         storage_writer=dcp.FileSystemWriter(path, overwrite=True))
    if not torch.distributed.is_initialized() \
            or torch.distributed.get_rank() == 0:
        with open(path + ".meta.json", "w") as f:
            json.dump({"meta": meta or {}}, f)


def load_orbax(path: str, like):
    """Restore a tree saved by :func:`save_orbax` into ``like``'s structure:
    each leaf takes the type, shape, dtype and device of ``like``'s leaf
    (a tensor or a NumPy array)."""
    import torch.distributed.checkpoint as dcp

    leaves = _flatten(like)
    state = {k: torch.empty_like(v) for k, v in _dcp_state(leaves).items()}
    _dcp(dcp.load, state, checkpoint_id=os.path.abspath(path))
    out = [state[f"arr_{i}"] if isinstance(leaf, torch.Tensor)
           else state[f"arr_{i}"].numpy() for i, leaf in enumerate(leaves)]
    return _unflatten(like, iter(out))


def surrogate_tree(model, scaler) -> dict:
    """The ``{"params": ..., "scaler": (shift, scale)}`` tree of a surrogate
    checkpoint, in the JAX package's layout."""
    return {"params": interop.lstm_params_to_numpy(model),
            "scaler": interop.scaler_to_numpy(scaler)}


def save_surrogate(path: str, model, scaler, meta: dict | None = None):
    save(path, surrogate_tree(model, scaler), meta)


def load_surrogate(path: str, *, dtype=None, device="cuda"):
    """(``LSTMSurrogate`` on ``device``, ``Scaler`` on the CPU) from a
    surrogate checkpoint.  Its leaves are ``b_out`` (O,) if the readout has
    a bias, then ``w_hh`` (H, 4H) and ``w_ih`` (I_l, 4H) per layer, then
    ``w_out`` (H, O), then the scaler's shift and scale (I,): the layout is
    read from these shapes and checked against them."""
    arrs = _leaves(path)
    has_bias = len(arrs) > 0 and arrs[0].ndim == 1
    n_layers = (len(arrs) - 3 - has_bias) // 2
    if n_layers < 1 or len(arrs) != has_bias + 2 * n_layers + 3:
        raise ValueError(f"{path}: {len(arrs)} leaves are not a surrogate "
                         "checkpoint ([b_out], (w_hh, w_ih) per layer, "
                         "w_out, shift, scale)")
    like = {"params": {"layers": [{"w_hh": 0, "w_ih": 0}] * n_layers,
                       "w_out": 0},
            "scaler": (0, 0)}
    if has_bias:
        like["params"]["b_out"] = 0
    tree = load(path, like)
    p, (shift, scale) = tree["params"], tree["scaler"]
    H = p["layers"][0]["w_hh"].shape[0]
    I = p["layers"][0]["w_ih"].shape[0]
    O = p["w_out"].shape[-1]
    shapes_ok = (
        all(l["w_hh"].shape == (H, 4 * H) for l in p["layers"])
        and [l["w_ih"].shape for l in p["layers"]]
        == [(I if i == 0 else H, 4 * H) for i in range(n_layers)]
        and p["w_out"].shape == (H, O)
        and (not has_bias or p["b_out"].shape == (O,))
        and shift.shape == scale.shape == (I,))
    if not shapes_ok:
        raise ValueError(
            f"{path}: leaf shapes {[a.shape for a in arrs]} do not form a "
            "surrogate checkpoint")
    return (interop.lstm_params_from_numpy(p, dtype=dtype, device=device),
            interop.scaler_from_numpy((shift, scale), device="cpu"))


def controller_tree(params: dict, in_scaler, out_scaler) -> dict:
    """The ``{"params": ..., "in_scaler": (shift, scale), "out_scaler":
    (shift, scale)}`` tree of an FNN controller checkpoint, in the JAX
    package's layout (leaves ``arr_0..arr_8``: the two scalers' shift and
    scale, then b_in, b_int, w_in, w_int, w_out)."""
    return {"params": interop.fnn_params_to_numpy(params),
            "in_scaler": interop.scaler_to_numpy(in_scaler),
            "out_scaler": interop.scaler_to_numpy(out_scaler)}


def save_controller(path: str, params: dict, in_scaler, out_scaler, *,
                    width_dim: int = 1, pipeline: str = "supervised") -> None:
    save(path, controller_tree(params, in_scaler, out_scaler),
         meta={"width_dim": width_dim, "pipeline": pipeline})


def load_controller(path: str, *, dtype=None, device="cuda"):
    """(params on ``device``, in_scaler, out_scaler on the CPU, meta) from an
    FNN controller checkpoint written by either package.  ``dtype`` defaults
    to the stored one; the scalers keep theirs.  The unsupervised
    pipeline's checkpoints store no ``width_dim`` (their FNN is always
    width 1): the meta returned then says 1."""
    like = {"params": dict.fromkeys(interop.FNN_KEYS, 0),
            "in_scaler": (0, 0), "out_scaler": (0, 0)}
    tree = load(path, like)
    p = tree["params"]
    n_in, hid = p["w_in"].shape
    ok = (p["w_int"].shape == (hid, hid) and p["b_in"].shape == (hid,)
          and p["b_int"].shape == (hid,) and p["w_out"].shape[0] == hid
          and all(a.shape in ((n_in,), ()) for a in tree["in_scaler"]))
    if not ok:
        raise ValueError(f"{path}: leaf shapes do not form an FNN controller "
                         "checkpoint")
    return (interop.fnn_params_from_numpy(p, dtype=dtype, device=device),
            interop.scaler_from_numpy(tree["in_scaler"], device="cpu"),
            interop.scaler_from_numpy(tree["out_scaler"], device="cpu"),
            {"width_dim": 1, **load_meta(path)})
