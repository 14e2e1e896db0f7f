"""Supervised imitation pipeline.

Port of ``forging_control_tpu/pipelines/supervised.py`` (the reference's
``Supervised Learning/Main.py``): train an FNN controller to imitate the
recorded MPC commands, then evaluate the MPC and the NN in closed loop on
the same CPython-exact reference streams and tabulate the comparison.

  1. dataset -> features [y_dot, z, ref], target u   (Main.py:176-190)
  2. 60/20/20 trajectory-ordered split, MaxAbs scalers fit on train
  3. FNN 3->50->1, L1 loss, AdamW lr=1e-3              (Main.py:272-286)
  4. held-out imitation metrics (scaled MAE/RMSE/R2)   (Main.py:305-317)
  5. MPC baseline closed loop                           (Main.py:391-420)
  6. NN closed loop (optional feasibility recovery)     (Main.py:610-646)
  7. tables + dataframe dumps                           (Main.py:820-859)

The MPC baseline is the condensed GN-SQP at N <= 12 (``backend="auto"``)
with the port's default ``linsolve="kernel"``: on a card every damped
normal solve is one launch of kernel B1, ``gn_iters x al_iters`` = 12 per
control step.
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from .. import interop, runtime
from ..device import resolve_device
from ..eval import metrics, report
from ..loop import closed_loop as cl
from ..nn import datasets, fnn, scalers, train
from ..parallel import mesh as pmesh
from ..refgen import streams
from ..solver import feasibility, sqp
from ..utils import checkpoint
from .config import PROCESS_STD, SupervisedConfig

PRESETS = {"default": sqp.MPCConfig, "fast": sqp.MPCConfig.fast,
           "ipopt_compat": sqp.MPCConfig.ipopt_compat}


@dataclasses.dataclass
class SupervisedArtifacts:
    params: dict
    in_scaler: scalers.Scaler
    out_scaler: scalers.Scaler
    test_metrics: dict
    train_report: train.TrainReport
    mpc_metrics: dict | None = None
    nn_metrics: dict | None = None
    mpc_telem: object = None
    nn_telem: object = None


def prepare_data(results: dict, cfg: SupervisedConfig):
    """Features/targets/scalers from a generated dataset (Main.py:176-231):
    ((x, y) of the training, validation and test splits as scaled NumPy
    arrays, in_scaler, out_scaler).  The scalers are fit on the training
    rows and keep the data's dtype, as in the JAX package."""
    feats = np.stack([np.asarray(results["y_dot"]).ravel(),
                      np.asarray(results["z"]).ravel(),
                      np.asarray(results["ref"]).ravel()], axis=1)
    targ = np.array(np.asarray(results["u"]).ravel()[:, None])
    tr, va, te = datasets.split_603030(len(feats))
    in_sc = scalers.fit(cfg.scaler, feats[tr])
    out_sc = scalers.fit(cfg.scaler, targ[tr])

    def prep(sl):
        return (in_sc.transform(torch.from_numpy(feats[sl])).numpy(),
                out_sc.transform(torch.from_numpy(targ[sl])).numpy())

    return prep(tr), prep(va), prep(te), in_sc, out_sc


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(results: dict, cfg: SupervisedConfig = SupervisedConfig(), *,
        seed: int = 0, closed_loop_eval: bool = True,
        out_dir: str | None = None, dtype=torch.float32, device="cuda",
        init_params: dict | None = None, perms=None,
        refs: dict | None = None) -> SupervisedArtifacts:
    """Train and evaluate on ``device`` in ``dtype``.

    ``init_params``: the initial weights as the JAX package's FNN params
    pytree of NumPy arrays (e.g. its ``fnn.init`` from ``PRNGKey(seed)``);
    by default they are drawn from a ``torch.Generator`` seeded with the
    training seed.  ``perms``: the per-epoch batch tables (see
    ``train.train_supervised``; per round with ``train_mode="dagger"``).
    ``refs`` {"val": closed-loop validation streams, "dagger": per-round
    streams} replace the draws of DAgger and its validation (see
    ``train.train_dagger``).  They apply to a single training run
    (``n_seeds == 1``).
    """
    if cfg.n_seeds > 1 and (init_params is not None or perms is not None):
        raise ValueError("init_params and perms set one training run; "
                         f"n_seeds is {cfg.n_seeds}")
    device = resolve_device(device)
    refs = refs or {}
    (xtr, ytr), (xva, yva), (xte, yte), in_sc, out_sc = prepare_data(
        results, cfg)
    noise = PROCESS_STD if cfg.flags.enable_noise else (0.0,) * 5

    def initial(s):
        if init_params is not None:
            return interop.fnn_params_from_numpy(init_params, dtype=dtype,
                                                 device=device)
        return fnn.init(torch.Generator().manual_seed(s),
                        hidden_dim=cfg.hidden_dim, width_dim=cfg.width_dim,
                        dtype=dtype, device=device)[0]

    params = initial(seed)
    if cfg.flags.enable_training:
        # Multi-seed selection (the reference's "sim" replicas) and DAgger's
        # rounds by true-plant closed-loop validation MAE on held-out
        # streams, with the deployment's noise.
        cl_val_fn = None
        if cfg.n_seeds > 1 or cfg.train_mode == "dagger":
            cl_val_fn = train.make_closed_loop_val(
                in_sc, out_sc, n_traj=16, t_traj=cfg.t_traj, dtype=dtype,
                seed=seed, ref_variant="supervised",
                width_dim=cfg.width_dim, process_std=noise,
                refs=refs.get("val"), device=device)

        def train_one(s):
            if cfg.train_mode == "dagger":
                # Iterated imitation: the chain's own MPC teacher relabels
                # the student's closed-loop states each round; round 0 is
                # the deployment-aligned full-density pairing.
                from .unsupervised import _full_density
                xf, uf, xvf, uvf = _full_density(results, in_sc, out_sc,
                                                 dtype)
                return train.train_dagger(
                    initial(s), in_sc, out_sc, xf, uf, xvf, uvf,
                    mpc_cfg=PRESETS[cfg.solver_preset](horizon=cfg.horizon,
                                                       variant="smooth"),
                    rounds=cfg.dagger_rounds, n_traj=cfg.dagger_n_traj,
                    t_steps=cfg.t_traj, epochs=cfg.dagger_epochs,
                    ref_variant="supervised", width_dim=cfg.width_dim,
                    backend=cl.resolve_backend("auto", cfg.horizon),
                    process_std=noise, seed=s, closed_loop_val_fn=cl_val_fn,
                    perms=perms, refs=refs.get("dagger"))
            return train.train_supervised(
                initial(s), xtr, ytr, xva, yva, width_dim=cfg.width_dim,
                lr=cfg.lr, epochs=cfg.epochs, batch_size=cfg.batch_size,
                seed=s, perms=perms, mesh=pmesh.default_mesh(device=device))

        best = None
        for k in range(max(1, cfg.n_seeds)):
            s = seed + 1000 * k
            p_k, rep_k = train_one(s)
            score = float(cl_val_fn(p_k)) if cl_val_fn is not None else 0.0
            if best is None or score < best[0]:
                best = (score, s, p_k, rep_k)
        _, sel_seed, params, rep = best
        rep.selected_seed = sel_seed
    else:
        rep = train.TrainReport()

    # Held-out imitation metrics in scaled units (Main.py:305-317).
    with torch.no_grad():
        pred = fnn.apply(params, torch.from_numpy(xte).to(device),
                         cfg.width_dim)
    truth = torch.from_numpy(yte).to(device)
    test_metrics = {
        "MAE": float(metrics.mae(truth, pred)),
        "RMSE": float(metrics.rmse(truth, pred)),
        "R2": float(metrics.r2(truth, pred)),
        "Training_time": rep.wall_time_s,
    }

    art = SupervisedArtifacts(params, in_sc, out_sc, test_metrics, rep)
    if not closed_loop_eval:
        return art

    # Closed-loop A/B on the same seeded reference streams.
    loop_cfg = cl.LoopConfig(t_steps=cfg.t_traj, variant="smooth",
                             process_std=noise)
    refs = torch.as_tensor(streams.reference_table(
        cfg.n_traj_eval, "supervised", cfg.t_traj), device=device).to(dtype)
    x0 = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(cfg.n_traj_eval, 1)

    mpc_cfg = PRESETS[cfg.solver_preset](
        horizon=cfg.horizon, variant="smooth", gn_iters=6, al_iters=2,
        p_max=32e6 if cfg.flags.enable_feasibility else None)
    mpc_ctrl = cl.MPCController(mpc_cfg, backend=cfg.backend)

    policy = fnn.make_policy(params, in_sc, out_sc, cfg.width_dim,
                             cfg.lb_u, cfg.ub_u)
    if cfg.flags.enable_feasibility:
        policy = feasibility.make_recovering_policy(
            policy, feasibility.FeasibilityConfig(), cfg.lb_u, cfg.ub_u)
    nn_ctrl = cl.FunctionController(policy)

    def run_once(ctrl):
        # The same noise in every run: a generator seeded anew.
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs,
                                torch.Generator().manual_seed(seed + 1),
                                device=device)
        return telem

    def timed_run(ctrl):
        """A warm run (first-call set-up: kernel build and load), then the
        timed run between two synchronisations; ms per batched step."""
        run_once(ctrl)
        _sync(device)
        t0 = time.perf_counter()
        telem = run_once(ctrl)
        _sync(device)
        return telem, (time.perf_counter() - t0) / cfg.t_traj * 1e3

    def loop_metrics(telem, per_step_ms, ctrl):
        m = {k: float(v) for k, v in metrics.tracking_metrics(
            telem.ref.reshape(-1), telem.x[..., 1].reshape(-1)).items()}
        m["Command"] = float(np.abs(telem.u.cpu().numpy()).mean())
        if cfg.latency_profile:
            # Sequential per-step latencies (the reference's Timer
            # semantics): the CPU stepper fills the reference-format
            # columns, the card stepper's mean is Tunnel_time.
            stepper = cl.controller_latency_metrics(
                loop_cfg, ctrl, refs[0], dtype=dtype, device=device)
            if isinstance(ctrl, cl.MPCController):
                # The real-time MPC path is the native C++ GN-SQP
                # (runtime/): its per-step distribution fills the
                # reference-format columns, labelled Time_impl, and the
                # port's stepper keeps the JAX package's column names.
                try:
                    _, _, t_nat = cl.native_mpc_latency(loop_cfg, ctrl.cfg,
                                                        refs[0])
                except runtime.NativeBuildError as e:
                    print(f"supervised: native runtime unavailable, the "
                          f"stepper fills the latency columns: {e}",
                          file=sys.stderr)
                    m.update(stepper)
                else:
                    m.update(metrics.latency_stats(t_nat))
                    m["Time_impl"] = "native_cpp_sqp"
                    m["Jax_stepper_mean"] = stepper["Mean_time"]
                    m["Jax_stepper_median"] = stepper["Median_time"]
                    if "Tunnel_time" in stepper:
                        m["Tunnel_time"] = stepper["Tunnel_time"]
            else:
                m.update(stepper)
        else:
            m["Mean_time"] = per_step_ms
            m["Median_time"] = per_step_ms
        m["Amortized_time"] = per_step_ms
        return m

    mpc_telem, mpc_ms = timed_run(mpc_ctrl)
    nn_telem, nn_ms = timed_run(nn_ctrl)
    art.mpc_metrics = loop_metrics(mpc_telem, mpc_ms, mpc_ctrl)
    art.nn_metrics = loop_metrics(nn_telem, nn_ms, nn_ctrl)
    art.mpc_telem, art.nn_telem = mpc_telem, nn_telem

    if out_dir:
        sfx = f"N_{cfg.horizon}" + ("_process_noise" if cfg.flags.enable_noise
                                    else "")
        sub = "Feasibility" if cfg.flags.enable_feasibility else "Normal"
        checkpoint.save_controller(
            f"{out_dir}/results/NN_controller_{sfx}.npz", params, in_sc,
            out_sc, width_dim=cfg.width_dim, pipeline="supervised")
        for name, table in (("test", art.test_metrics),
                            ("MPC", art.mpc_metrics), ("NN", art.nn_metrics)):
            report.show_tabulate(
                table, f"{out_dir}/Tables/{sub}/{name}_results_{sfx}.csv",
                echo=False)
        report.dump_dataframe(f"{out_dir}/results/MPC_dataframe.txt",
                              mpc_telem)
        report.dump_dataframe(f"{out_dir}/results/Supervised_dataframe.txt",
                              nn_telem)
    return art
