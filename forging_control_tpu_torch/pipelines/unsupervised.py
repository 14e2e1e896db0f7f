"""Unsupervised (MPC-loss) controller pipeline.

Port of ``forging_control_tpu/pipelines/unsupervised.py`` (the reference's
``Unsupervised Learning/Main.py``): train the FNN controller, then evaluate
it in closed loop against the true plant beside a free-running rollout of
the surrogate.  Three train modes:

* ``"surrogate"`` (the reference protocol): the MPC loss unrolled through
  the frozen LSTM surrogate (``nn.train.train_unsupervised``), on a cosine
  schedule by default;
* ``"plant"``: backpropagation through the true RK4 plant
  (``train_plant_in_loop``), after an optional imitation pretrain;
* ``"dagger"``: iterated imitation with the MPC teacher relabelling the
  student's own states (``train_dagger``; its SQP teacher runs kernel B1 on
  a card), then an optional plant fine-tune.

The free-running drift test feeds the surrogate its own predictions, one
no-grad forward per step at batch 1: ``t_traj - lookback`` launches of
kernel B2 on a card.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import interop
from ..device import resolve_device
from ..eval import metrics
from ..loop import closed_loop as cl
from ..nn import datasets, fnn, scalers, surrogate_eval, train
from ..refgen import streams
from ..solver import feasibility
from ..utils import checkpoint
from .config import PROCESS_STD, UnsupervisedConfig
from .supervised import PRESETS
from .surrogate import SURROGATE_FEATURES

TRAJ_LEN = 300        # rows per trajectory in the reference datasets


@dataclasses.dataclass
class UnsupervisedArtifacts:
    params: dict
    in_scaler: scalers.Scaler
    out_scaler: scalers.Scaler
    test_metrics: dict
    train_report: train.TrainReport
    nn_metrics: dict | None = None
    surrogate_drift: dict | None = None
    nn_telem: object = None


def _controller_scalers(results: dict, scaler_kind: str):
    """(y_dot, z, u scalers fit on the training split, in_sc over [y_dot,
    z, ref] with the reference scaled by the y_dot scaler)."""
    tr, _, _ = datasets.split_603030(np.asarray(results["y_dot"]).size)
    ydot_sc, z_sc, u_sc = (
        scalers.fit(scaler_kind, np.asarray(results[k]).ravel()[tr, None])
        for k in ("y_dot", "z", "u"))
    in_sc = scalers.Scaler(
        shift=torch.cat([ydot_sc.shift[:1], z_sc.shift[:1],
                         ydot_sc.shift[:1]]),
        scale=torch.cat([ydot_sc.scale[:1], z_sc.scale[:1],
                         ydot_sc.scale[:1]]))
    return ydot_sc, z_sc, u_sc, in_sc


def fit_controller_scalers(results: dict, scaler_kind: str = "maxabs"):
    """Controller feature/command scalers exactly as :func:`prepare_data`
    fits them: per-column maxabs on the train split, with the reference
    signal scaled by the *y_dot* scaler (Unsupervised Learning/
    Main.py:235-261).  Returns ``(in_sc, u_sc)`` on the CPU."""
    _, _, u_sc, in_sc = _controller_scalers(results, scaler_kind)
    return in_sc, u_sc


def prepare_data(results: dict, state_scaler, cfg: UnsupervisedConfig,
                 scaler_kind: str = "maxabs", dtype=torch.float32):
    """Controller features [y_dot, z, ref] (ref scaled with the *y_dot*
    scaler, Unsupervised Learning/Main.py:235-261), target u at t+1, and
    recurrent surrogate windows; every-N-th resampling (Main.py:282-309).

    Returns the (x, u, window) triples of the training, validation and
    test splits as NumPy arrays in ``dtype``, their values rounded through
    float32 as the JAX package casts them whatever its dtype, then in_sc
    and u_sc."""
    y_dot, z, ref = (np.asarray(results[k]).ravel() for k in
                     ("y_dot", "z", "ref"))
    u = np.asarray(results["u"]).ravel()[:, None]
    tr, va, te = datasets.split_603030(len(y_dot))
    ydot_sc, z_sc, u_sc, in_sc = _controller_scalers(results, scaler_kind)

    def scaled(sc, a):
        return sc.transform(torch.from_numpy(np.ascontiguousarray(a))).numpy()

    feats = np.stack([scaled(ydot_sc, y_dot[:, None])[:, 0],
                      scaled(z_sc, z[:, None])[:, 0],
                      scaled(ydot_sc, ref[:, None])[:, 0]], axis=1)
    targ = scaled(u_sc, u)
    track = np.stack([np.asarray(results[k]).ravel()
                      for k in SURROGATE_FEATURES], axis=1)
    track_s = scaled(state_scaler, track)
    np_dtype = _np_dtype(dtype)

    def triples(sl):
        x, y, zz = datasets.unsupervised_triples(
            feats[sl], targ[sl], track_s[sl], cfg.lookback,
            traj_len=TRAJ_LEN)
        keep = datasets.resample_every(len(x), cfg.horizon)
        return tuple(a[keep].astype(np.float32).astype(np_dtype)
                     for a in (x, y, zz))

    return triples(tr), triples(va), triples(te), in_sc, u_sc


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _full_density(results: dict, in_sc, u_sc, dtype=torch.float32):
    """Full-density deployment-aligned pairs in scaled units, DAgger's and
    the plant pretrain's imitation set (the every-N-th MPC-loss resampling
    starves it): within each trajectory, (y_dot[t], z[t], ref[t+1]) ->
    u[t+1], since a telemetry row pairs the post-step state with the
    command that produced it.  As in the JAX package, the raw pairs and the
    scaled commands are rounded through float32 whatever the dtype, and
    cast to ``dtype``.  Returns (x_train, u_train, x_val, u_val)."""
    np_dtype = _np_dtype(dtype)
    y_dot, z, ref, u = (np.asarray(results[k]) for k in
                        ("y_dot", "z", "ref", "u"))
    feats = np.stack([y_dot[:, :-1], z[:, :-1], ref[:, 1:]], axis=-1)
    feats = feats.reshape(-1, 3).astype(np.float32).astype(np_dtype)
    targ = u[:, 1:].reshape(-1, 1).astype(np.float32).astype(np_dtype)
    tr, va, _ = datasets.split_603030(len(feats))
    feats_s = in_sc.transform(torch.from_numpy(feats)).numpy()
    targ_s = u_sc.transform(torch.from_numpy(targ)).numpy()
    targ_s = targ_s.astype(np.float32).astype(np_dtype)
    return feats_s[tr], targ_s[tr], feats_s[va], targ_s[va]


def make_closed_loop_val(in_sc, u_sc, *, n_traj: int = 8, t_traj: int = 300,
                         dtype=torch.float32, seed: int = 0,
                         variant: str = "smooth",
                         process_std: tuple = (0.0,) * 5, refs=None,
                         device="cuda"):
    """True-plant validation rollout on "unsupervised" streams (see
    ``nn.train.make_closed_loop_val``)."""
    return train.make_closed_loop_val(
        in_sc, u_sc, n_traj=n_traj, t_traj=t_traj, dtype=dtype, seed=seed,
        variant=variant, ref_variant="unsupervised", process_std=process_std,
        refs=refs, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(results: dict, surrogate, state_scaler,
        cfg: UnsupervisedConfig = UnsupervisedConfig(), *, seed: int = 0,
        closed_loop_eval: bool = True, dtype=torch.float32,
        t_traj: int = 300, n_traj_eval: int = 2, out_dir: str | None = None,
        device="cuda", init_params: dict | None = None, perms=None,
        noise: dict | None = None,
        refs: dict | None = None) -> UnsupervisedArtifacts:
    """Train and evaluate on ``device`` in ``dtype``.

    ``surrogate`` is the trained ``LSTMSurrogate`` (its dtype and device are
    the run's), ``state_scaler`` its scaler.  Parity hooks, for a single
    training run (``n_seeds == 1``), each replacing the draws of a
    ``torch.Generator``:

    * ``init_params``: the initial weights as the JAX package's FNN params
      pytree of NumPy arrays (its ``fnn.init`` from ``PRNGKey(seed)``);
    * ``perms``: the batch tables of the mode's trainer
      (``train_unsupervised``, the plant pretrain's ``train_supervised``, or
      per round ``train_dagger``'s);
    * ``noise``: {"mpc_loss": per-epoch per-batch MPC-loss draws, "plant":
      per-step plant noise, "dagger": per-round rollout noise};
    * ``refs``: {"val": the closed-loop validation streams, "plant":
      per-step streams, "dagger": per-round streams}.

    The evaluation loop's process noise is drawn from a generator seeded
    with ``seed + 1``.
    """
    if cfg.n_seeds > 1 and (init_params is not None or perms is not None):
        raise ValueError("init_params and perms set one training run; "
                         f"n_seeds is {cfg.n_seeds}")
    device = resolve_device(device)
    noise, refs = noise or {}, refs or {}
    (xtr, utr, ztr), (xva, uva, _), (xte, ute, _), in_sc, u_sc = prepare_data(
        results, state_scaler, cfg, dtype=dtype)
    proc = PROCESS_STD if cfg.flags.enable_noise else (0.0,) * 5

    def initial(s):
        if init_params is not None:
            return interop.fnn_params_from_numpy(init_params, dtype=dtype,
                                                 device=device)
        return fnn.init(torch.Generator().manual_seed(s), dtype=dtype,
                        device=device)[0]

    params = initial(seed)
    if cfg.flags.enable_training:
        cl_val_fn = None
        if cfg.closed_loop_val:
            # Validate under the deployment noise protocol: selection on
            # clean rollouts misranks policies when evaluation is noisy.
            cl_val_fn = make_closed_loop_val(
                in_sc, u_sc, n_traj=cfg.closed_loop_val_traj, t_traj=t_traj,
                dtype=dtype, seed=seed, process_std=proc,
                refs=refs.get("val"), device=device)

        def plant(p, s):
            return train.train_plant_in_loop(
                p, in_sc, u_sc, t_steps=t_traj, n_traj=cfg.plant_n_traj,
                steps=cfg.plant_steps, lr=cfg.plant_lr, rterm=0.02, seed=s,
                process_std=proc, closed_loop_val_fn=cl_val_fn,
                refs=refs.get("plant"), noise=noise.get("plant"))

        def train_one(s):
            p0 = initial(s)
            if cfg.train_mode == "dagger":
                mpc_cfg = PRESETS[cfg.solver_preset](horizon=cfg.horizon,
                                                     variant="smooth")
                # Round 0 imitates the full-density dataset.
                xf, uf, xvf, uvf = _full_density(results, in_sc, u_sc, dtype)
                p1, rep1 = train.train_dagger(
                    p0, in_sc, u_sc, xf, uf, xvf, uvf, mpc_cfg=mpc_cfg,
                    rounds=cfg.dagger_rounds, n_traj=cfg.dagger_n_traj,
                    t_steps=t_traj, epochs=cfg.dagger_epochs, seed=s,
                    backend=cl.resolve_backend("auto", cfg.horizon),
                    process_std=proc, closed_loop_val_fn=cl_val_fn,
                    perms=perms, refs=refs.get("dagger"),
                    noise=noise.get("dagger"))
                if not cfg.dagger_plant_finetune:
                    return p1, rep1
                p2, rep2 = plant(p1, s)
                # Keep whichever stage validated best on the shared panel
                # (the fine-tune starts from p1 but can wander).
                keep_p1 = (cl_val_fn is not None and rep1.cl_val_losses
                           and rep2.cl_val_losses
                           and min(rep1.cl_val_losses)
                           < min(rep2.cl_val_losses))
                rep2.train_losses = rep1.train_losses + rep2.train_losses
                rep2.cl_val_losses = rep1.cl_val_losses + rep2.cl_val_losses
                rep2.wall_time_s += rep1.wall_time_s
                return (p1 if keep_p1 else p2), rep2
            if cfg.train_mode == "plant":
                if cfg.plant_pretrain:
                    # Imitation pretrain on the full-density teacher data,
                    # then refine through the true plant.
                    xf, uf, xvf, uvf = _full_density(results, in_sc,
                                                     u_sc, dtype)
                    p0, _ = train.train_supervised(
                        p0, xf, uf, xvf, uvf,
                        epochs=cfg.plant_pretrain_epochs, seed=s,
                        perms=perms)
                return plant(p0, s)
            bs = max(cfg.batch_size, 1)
            lr = cfg.lr
            if cfg.lr_schedule == "cosine":
                lr = train.cosine_decay_schedule(
                    cfg.lr, max(1, len(xtr) // bs) * cfg.epochs)
            return train.train_unsupervised(
                p0, surrogate, xtr, utr, ztr, xva, uva, horizon=cfg.horizon,
                alpha=cfg.alpha, lr=lr, epochs=cfg.epochs, batch_size=bs,
                enable_noise=cfg.flags.enable_noise, seed=s,
                closed_loop_val_fn=cl_val_fn, perms=perms,
                noise=noise.get("mpc_loss"))

        # Multi-seed selection by true-plant closed-loop val MAE (the
        # reference's 10 "sim" replicas; see UnsupervisedConfig.n_seeds).
        best = None
        for k in range(max(1, cfg.n_seeds)):
            s = seed + 1000 * k
            p_k, rep_k = train_one(s)
            score = (float(cl_val_fn(p_k)) if cl_val_fn is not None
                     and cfg.n_seeds > 1 else 0.0)
            if best is None or score < best[0]:
                best = (score, s, p_k, rep_k)
        _, sel_seed, params, rep = best
        rep.selected_seed = sel_seed
    else:
        rep = train.TrainReport()

    with torch.no_grad():
        pred = fnn.apply(params, torch.from_numpy(xte).to(device))
    truth = torch.from_numpy(ute).to(device)
    test_metrics = {
        "MAE": float(metrics.mae(truth, pred)),
        "RMSE": float(metrics.rmse(truth, pred)),
        "R2": float(metrics.r2(truth, pred)),
        "Training_time": rep.wall_time_s,
    }
    art = UnsupervisedArtifacts(params, in_sc, u_sc, test_metrics, rep)
    if not closed_loop_eval:
        return art

    policy = fnn.make_policy(params, in_sc, u_sc)
    if cfg.flags.enable_feasibility:
        policy = feasibility.make_recovering_policy(
            policy, feasibility.FeasibilityConfig())
    ctrl = cl.FunctionController(policy)
    loop_cfg = cl.LoopConfig(t_steps=t_traj, variant="smooth",
                             process_std=proc)
    eval_refs = torch.as_tensor(streams.reference_table(
        n_traj_eval, "unsupervised", t_traj), device=device).to(dtype)
    x0 = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(n_traj_eval, 1)

    def run_once():
        # The same noise in every run: a generator seeded anew.
        with torch.no_grad():
            return cl.run_batch(loop_cfg, ctrl, x0, eval_refs,
                                torch.Generator().manual_seed(seed + 1),
                                device=device)[1]

    run_once()                   # warm run (first-call set-up)
    _sync(device)
    t0 = time.perf_counter()
    telem = run_once()
    _sync(device)
    per_step_ms = (time.perf_counter() - t0) / t_traj * 1e3

    nn_metrics = {k: float(v) for k, v in metrics.tracking_metrics(
        telem.ref.reshape(-1), telem.x[..., 1].reshape(-1)).items()}
    nn_metrics["Command"] = float(np.abs(telem.u.cpu().numpy()).mean())
    if cfg.latency_profile:
        # Sequential per-step latencies: the CPU stepper fills the
        # reference-format columns, the card stepper's mean is Tunnel_time.
        with torch.no_grad():
            nn_metrics.update(cl.controller_latency_metrics(
                loop_cfg, ctrl, eval_refs[0], dtype=dtype, device=device))
    else:
        nn_metrics["Mean_time"] = per_step_ms
    nn_metrics["Amortized_time"] = per_step_ms
    art.nn_metrics = nn_metrics
    art.nn_telem = telem

    # Free-running surrogate rollout against the true plant's trajectory
    # (Unsupervised Learning/Functions.py:1014-1289).
    track = surrogate_eval.build_feature_track(telem, state_scaler, traj=0)
    preds = surrogate_eval.free_running(surrogate, track, cfg.lookback)
    art.surrogate_drift = surrogate_eval.fidelity_metrics(
        preds[:-1], track[cfg.lookback + 1:, :4])

    if out_dir:
        write_artifacts(art, cfg, out_dir)
    return art


def write_artifacts(art: UnsupervisedArtifacts, cfg: UnsupervisedConfig,
                    out_dir: str) -> None:
    """Reference-format artifacts (Unsupervised Learning/Main.py:895-934):
    the tables under ``<out>/Unsupervised/Tables/`` (the reference keeps
    each experiment's tables in its own directory), the telemetry
    dataframe, and the controller checkpoint
    ``results/NN_controller_unsupervised_<sfx>.npz`` with the JAX
    package's meta."""
    from ..eval import report
    sfx = f"N_{cfg.horizon}" + ("_noise" if cfg.flags.enable_noise else "")
    sub = "Feasibility" if cfg.flags.enable_feasibility else "Normal"
    base = f"{out_dir}/Unsupervised/Tables/{sub}"
    report.show_tabulate(art.test_metrics,
                         f"{base}/test_results_{sfx}.csv", echo=False)
    report.show_tabulate(art.nn_metrics,
                         f"{base}/NN_results_{sfx}.csv", echo=False)
    report.dump_dataframe(f"{out_dir}/results/Unsupervised_dataframe.txt",
                          art.nn_telem)
    checkpoint.save(
        f"{out_dir}/results/NN_controller_unsupervised_{sfx}.npz",
        checkpoint.controller_tree(art.params, art.in_scaler, art.out_scaler),
        meta={"train_mode": cfg.train_mode, "pipeline": "unsupervised"})
