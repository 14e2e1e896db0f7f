"""Dataset generation pipeline.

Port of ``forging_control_tpu/pipelines/generate_data.py`` (the reference's
``Generate Data/Main.py``): run the MPC in closed loop over ``n_traj``
trajectories with process noise and record the full telemetry, the whole
batch at once (``loop.closed_loop.run_batch``).

Datasets are ``.npz`` files with the reference result-dict schema
(y/y_dot/p1/p2/z/ref/u/F_d/w, ``Generate Data/Functions.py:381-390``) plus
solver diagnostics; they load in either package.  Process noise comes from
a CPU ``torch.Generator`` seeded with ``seed``; it is not the JAX package's
``jax.random`` noise, so only runs with noise off are held against it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..device import resolve_device
from ..eval import metrics
from ..loop import closed_loop as cl
from ..refgen import streams
from ..solver import sqp
from .config import GenerateConfig


def run(cfg: GenerateConfig = GenerateConfig(), *, seed: int = 0,
        exact_reference_streams: bool = True, dtype=torch.float32,
        device="cuda"):
    """Generate a dataset; returns (telemetry, results_dict).

    exact_reference_streams=True uses the CPython-parity seeded streams
    (replayable against the reference); False draws them from the seeded
    generator for arbitrary scale.
    """
    device = resolve_device(device)
    make = {"default": sqp.MPCConfig, "fast": sqp.MPCConfig.fast,
            "ipopt_compat": sqp.MPCConfig.ipopt_compat}[cfg.solver_preset]
    mpc_cfg = make(
        horizon=cfg.horizon,
        variant="raw" if cfg.variant_model == "raw" else "smooth",
        record_trace=cfg.record_trace)
    loop_cfg = cl.LoopConfig(
        t_steps=cfg.t_traj, variant=mpc_cfg.variant,
        process_std=cfg.process_std if cfg.flags.enable_noise else (0.0,) * 5,
        meas_std=cfg.meas_std)
    ctrl = cl.MPCController(mpc_cfg, backend=cfg.backend)

    gen = torch.Generator().manual_seed(seed)
    if exact_reference_streams:
        refs = torch.as_tensor(
            streams.reference_table(cfg.n_traj, cfg.ref_variant, cfg.t_traj),
            dtype=dtype, device=device)
    else:
        refs = streams.sample_references(gen, cfg.n_traj, cfg.ref_variant,
                                         cfg.t_traj, dtype, device)

    x0 = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(cfg.n_traj, 1)
    _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs, gen, device=device)

    def host(a):
        return a.detach().cpu().numpy()

    results = {
        "y": host(telem.x[..., 0]),
        "y_dot": host(telem.x[..., 1]),
        "p1": host(telem.x[..., 2]),
        "p2": host(telem.x[..., 3]),
        "z": host(telem.x[..., 4]),
        "ref": host(telem.ref),
        "u": host(telem.u),
        "F_d": host(telem.Fd),
        "w": host(telem.w),
        "iter": host(telem.diag.iters),
        "obj": host(telem.diag.obj),
        "inf_pr": host(telem.diag.inf_pr),
        "inf_du": host(telem.diag.inf_du),
    }
    return telem, results


def dataset_path(root: str, horizon: int) -> str:
    """forging_mult_traj_process_noise_N_{H} naming (Generate Data/Main.py:97)."""
    return os.path.join(root, f"forging_mult_traj_process_noise_N_{horizon}.npz")


def save(results: dict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **results)


def load(path: str) -> dict:
    """Load an ``.npz`` dataset.  The reference's pickled do-mpc ``.pkl``
    results need ``utils/dompc_pickle``, which is not ported yet (ROADMAP
    Queue A 14): such a path raises."""
    if path.endswith(".pkl"):
        raise NotImplementedError(
            f"{path}: reading do-mpc .pkl results needs utils/dompc_pickle, "
            "which the port does not have yet (ROADMAP Queue A 14); convert "
            "it to .npz with the JAX package")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def summarize(results: dict) -> dict:
    """Tracking metrics + solver health, the Main.py:104-115 log block."""
    ref = torch.as_tensor(results["ref"].ravel())
    y_dot = torch.as_tensor(results["y_dot"].ravel())
    out = {k: float(v) for k, v in metrics.tracking_metrics(ref, y_dot).items()}
    out["Command"] = float(np.abs(results["u"]).mean())
    out["iters_mean"] = float(results["iter"].mean())
    out["inf_pr_max"] = float(results["inf_pr"].max())
    return out
