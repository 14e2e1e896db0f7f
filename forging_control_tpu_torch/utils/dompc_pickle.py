"""Load the reference's pickled do-mpc result files WITHOUT do-mpc.

Port's own copy of ``forging_control_tpu/utils/dompc_pickle.py`` (NumPy and
pickle code, no jax).  When both packages are loaded in one process they
share one ``do_mpc.data`` stand-in (``sys.modules.setdefault``), so their
writers emit the same bytes and each reads the other's files.

The reference persists closed-loop runs via ``do_mpc.data.save_results``
(pickled dicts of ``do_mpc.data.Data`` objects — ``Supervised
Learning/Main.py:408``, ``Generate Data/Main.py:92-94``) and ships several
in its results directories.  Unpickling them normally requires do-mpc,
CasADi and their exact versions; this loader instead substitutes a blank
class for every unimportable type and extracts the plain-numpy telemetry
arrays, so users migrating from the reference can read their existing
``Data/*.pkl`` datasets and ``results/*.pkl`` recordings directly.

Array semantics (do-mpc Data, verified against the shipped recordings):
``_time`` (T,1) seconds; ``_x`` (T,5) = [y, y_dot, p1, p2, z] in declaration
order (``Generate Data/template_model.py:65-69``); ``_u`` (T,1) servo
tension; ``_tvp`` (T,1) speed reference; ``_aux`` (T,2) = [default,
Fd_article] (do-mpc prepends a 'default' aux expression; ``Fd_article`` is
set at ``template_model.py:123``).
"""

from __future__ import annotations

import pickle
import sys
import types

import numpy as np

_FIELDS = ("_time", "_x", "_y", "_u", "_z", "_tvp", "_p", "_aux")


class _Blank:
    def __init__(self, *args, **kwargs):
        pass


class _StubUnpickler(pickle.Unpickler):
    """Resolve importable classes normally; stub everything else."""

    def find_class(self, module, name):
        try:
            return super().find_class(module, name)
        except Exception:
            return type(name, (_Blank,), {"__module__": module})


def load(path: str) -> dict:
    """{key: {field: np.ndarray}} for each do-mpc Data object in the file.

    Keys are the reference's save names ('mpc', 'simulator', ...); fields
    are the recorded telemetry arrays (_time/_x/_u/_tvp/_aux/...).
    """
    with open(path, "rb") as f:
        raw = _StubUnpickler(f).load()
    out = {}
    for key, data in raw.items():
        rec = {}
        for field in _FIELDS:
            arr = getattr(data, field, None)
            if isinstance(arr, np.ndarray) and arr.size:
                rec[field] = np.asarray(arr)
        out[key] = rec
    return out


def to_results(rec: dict, t_traj: int = 300) -> dict:
    """Convert one Data record to this framework's results-dict schema
    (``pipelines/generate_data.run``): y/y_dot/p1/p2/z/ref/u/F_d shaped
    (n_traj, t_traj).  The reference's files hold n_traj back-to-back
    trajectories of t_traj steps (``Generate Data/Main.py:45-46``)."""
    x = rec["_x"]
    total = x.shape[0]
    if total % t_traj and "_time" in rec:
        # Our writer restarts the clock per trajectory (save's docstring):
        # infer the trajectory length from the restart points.
        t = rec["_time"][:, 0]
        n_restarts = int((t == t[0]).sum())
        if n_restarts and total % n_restarts == 0:
            t_traj = total // n_restarts
    if total % t_traj:
        raise ValueError(f"{total} rows not divisible by t_traj={t_traj}")
    n_traj = total // t_traj

    def col(a, j=0):
        return a[:, j].reshape(n_traj, t_traj).astype(np.float64)

    results = {
        "y": col(x, 0), "y_dot": col(x, 1), "p1": col(x, 2),
        "p2": col(x, 3), "z": col(x, 4),
        "ref": col(rec["_tvp"]),
        "u": col(rec["_u"]),
    }
    if "_aux" in rec and rec["_aux"].shape[1]:
        results["F_d"] = col(rec["_aux"], rec["_aux"].shape[1] - 1)
    return results


# ---------------------------------------------------------------------------
# Writer: emit the reference's pickled result format (do_mpc.data.
# save_results schema) so reference-side tooling can consume repo output.
# ---------------------------------------------------------------------------

def _dompc_class(name: str):
    """The class to pickle a Data record under.

    If do-mpc is importable, use the real ``do_mpc.data.{name}`` so the
    emitted file is bit-compatible with ``do_mpc.data.save_results``
    output.  Otherwise synthesize a stand-in whose ``__module__``/
    ``__name__`` point at do-mpc: pickle stores classes *by reference*
    (module + qualname), so a consumer that HAS do-mpc installed unpickles
    these records as genuine ``do_mpc.data.Data`` objects with our arrays
    as their ``_x``/``_u``/... attributes — exactly what the reference's
    scripts read (``Supervised Learning/Main.py:176-187``).  The stand-in
    module is registered in ``sys.modules`` only when do-mpc is absent
    (it never shadows a real install).
    """
    import importlib.util

    try:
        spec = importlib.util.find_spec("do_mpc")
    except ValueError:
        # Our own stand-in module is already registered (spec-less).
        spec = None
    if spec is not None:
        # A real install exists: use it (and surface its own import
        # errors, e.g. a broken casadi, rather than silently shadowing
        # the package with stand-ins).
        import do_mpc.data as dd
        return getattr(dd, name)
    mod = sys.modules.get("do_mpc.data")
    if mod is None or not hasattr(mod, name):
        pkg = sys.modules.setdefault("do_mpc", types.ModuleType("do_mpc"))
        mod = sys.modules.setdefault("do_mpc.data",
                                     types.ModuleType("do_mpc.data"))
        pkg.data = mod
        for cls_name in ("Data", "MPCData"):
            cls = type(cls_name, (), {"__module__": "do_mpc.data"})
            setattr(mod, cls_name, cls)
    return getattr(mod, name)


def _make_record(cls_name: str, fields: dict):
    obj = _dompc_class(cls_name).__new__(_dompc_class(cls_name))
    obj.__dict__.update(fields)
    obj.__dict__.setdefault("dtype", cls_name)
    return obj


def save(path: str, results: dict, dt: float = 1e-3) -> None:
    """Write a results dict in the reference's pickled format.

    The output mirrors ``do_mpc.data.save_results([mpc, simulator], name)``
    (``Generate Data/Main.py:92-94``): a pickled ``{'mpc': MPCData,
    'simulator': Data}`` whose records carry ``_time`` (T,1), ``_x`` (T,5)
    in declaration order [y, y_dot, p1, p2, z], ``_u`` (T,1), ``_tvp``
    (T,1) and ``_aux`` (T,2) = [default, Fd_article] — the exact array
    semantics :func:`load` documents.  Round-trips through
    ``load`` -> :func:`to_results` to the identical results dict
    (tests/test_torch_utils.py).

    Args:
      results: this framework's results schema (y/y_dot/p1/p2/z/ref/u/F_d
        shaped (n_traj, t_traj), ``pipelines/generate_data.run``).
      dt: control period for the _time column (template_mpc.py:23).
    """
    n_traj, t_traj = np.asarray(results["y"]).shape
    T = n_traj * t_traj

    def flat(key):
        return np.asarray(results[key], np.float64).reshape(T, 1)

    x = np.concatenate([flat(k) for k in ("y", "y_dot", "p1", "p2", "z")],
                       axis=1)
    # Per-trajectory clock, like the reference's per-run Data (each
    # trajectory restarts at t=0; Generate Data/Functions.py:325-349).
    t = np.tile(dt * np.arange(t_traj, dtype=np.float64), n_traj)[:, None]
    aux_fd = (flat("F_d") if "F_d" in results
              else np.zeros((T, 1), np.float64))
    fields = {
        "_time": t, "_x": x, "_u": flat("u"), "_tvp": flat("ref"),
        "_aux": np.concatenate([np.zeros((T, 1), np.float64), aux_fd],
                               axis=1),
    }
    payload = {
        "mpc": _make_record("MPCData", dict(fields)),
        "simulator": _make_record("Data", dict(fields)),
    }
    with open(path, "wb") as f:
        pickle.dump(payload, f, protocol=2)
