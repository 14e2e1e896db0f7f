"""Command-line entry points of the port.

Port of ``forging_control_tpu/cli.py``, with the same subcommands and flags.
Each subcommand logs its single JSON line of results through the package
logger (``utils/logging``), whose handler writes to standard error, as the
JAX CLI does:

    python -m forging_control_tpu_torch generate --n-traj 80 --horizon 25
    python -m forging_control_tpu_torch sweep --horizons 5 10 15 20 25
    python -m forging_control_tpu_torch supervised --data data/N_10.npz
    python -m forging_control_tpu_torch surrogate --data 'data/*.npz'
    python -m forging_control_tpu_torch unsupervised --data data/N_10.npz

Every subcommand runs on ``--device`` (default ``cuda``; ``cpu`` only when
asked).  ``surrogate`` reads its files in ``sorted(glob)`` order per
pattern, as the JAX package's CLI does (so ``N_10`` comes before ``N_5``).
``--plots`` writes the HTML dashboards (``eval/html_dash``) and the PNGs
(``eval/plots``, which needs matplotlib) under ``<out>/Images/`` and logs
their paths.  ``generate --export-pkl`` also writes the dataset as the
reference's do-mpc pickle (``utils/dompc_pickle``) beside the npz.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time

from .pipelines import config as pcfg
from .utils.logging import get_logger

log = get_logger()


def _flags(args) -> pcfg.Flags:
    return pcfg.Flags(
        enable_noise=args.noise,
        enable_training=not getattr(args, "no_training", False),
        enable_feasibility=getattr(args, "feasibility", False),
        silence_solver=True,
    )


def _emit(rec: dict) -> None:
    log.info(json.dumps(rec))


def _emit_dashboards(telem, out_dir: str, tag: str):
    """Interactive HTML dashboards (the reference's Plotly pages with the
    per-trajectory slider; Generate Data/Main.py:120-262) and PNGs matching
    the reference's results/Images/ files (Supervised Learning/
    Functions.py:1557-1565); their paths are logged."""
    import os

    from .eval import html_dash, plots
    p1 = os.path.join(out_dir, "Images", f"{tag}_closed_loop.html")
    p2 = os.path.join(out_dir, "Images", f"{tag}_solver.html")
    html_dash.dashboard_from_telemetry(telem, p1, title=f"{tag} closed loop")
    html_dash.solver_dashboard_from_telemetry(telem, p2,
                                              title=f"{tag} solver")
    outs = [p1, p2]
    for name, fn in (("closed_loop", plots.plot_closed_loop),
                     ("solver", plots.plot_solver_diagnostics)):
        png = os.path.join(out_dir, "Images", f"{tag}_{name}.png")
        fig = fn(telem, 0, png)
        import matplotlib.pyplot as plt
        plt.close(fig)
        outs.append(png)
    _emit({"dashboards": outs})


def cmd_generate(args):
    from .pipelines import generate_data
    cfg = pcfg.GenerateConfig(
        n_traj=args.n_traj, t_traj=args.t_traj, horizon=args.horizon,
        solver_preset=args.solver_preset, record_trace=args.trace,
        backend=args.backend, flags=_flags(args))
    t0 = time.time()
    telem, results = generate_data.run(
        cfg, seed=args.seed, exact_reference_streams=not args.random_refs,
        device=args.device)
    wall_s = time.time() - t0
    path = generate_data.dataset_path(args.out, cfg.horizon)
    generate_data.save(results, path)
    summ = generate_data.summarize(results)
    if args.export_pkl:
        from .utils import dompc_pickle
        pkl = path[:-4] + ".pkl"
        dompc_pickle.save(pkl, results)
        summ["dataset_pkl"] = pkl
    summ["backend"] = args.backend
    summ["wall_s"] = round(wall_s, 2)
    summ["solves"] = cfg.n_traj * cfg.t_traj
    _emit({"dataset": path, **summ})
    if args.plots:
        _emit_dashboards(telem, args.out, f"MPC_N_{cfg.horizon}")


def cmd_sweep(args):
    from .pipelines import generate_data
    for h in args.horizons:
        cfg = pcfg.GenerateConfig(n_traj=args.n_traj, t_traj=args.t_traj,
                                  horizon=h, flags=_flags(args))
        _, results = generate_data.run(
            cfg, seed=args.seed, exact_reference_streams=not args.random_refs,
            device=args.device)
        path = generate_data.dataset_path(args.out, h)
        generate_data.save(results, path)
        _emit({"dataset": path, **generate_data.summarize(results)})


def cmd_supervised(args):
    from .pipelines import generate_data, supervised
    results = generate_data.load(args.data)
    cfg = pcfg.SupervisedConfig(
        horizon=args.horizon, epochs=args.epochs, n_seeds=args.seeds,
        backend=args.backend, train_mode=args.train_mode, flags=_flags(args))
    art = supervised.run(results, cfg, seed=args.seed,
                         closed_loop_eval=not args.no_eval, out_dir=args.out,
                         device=args.device)
    _emit({"test": art.test_metrics, "mpc": art.mpc_metrics,
           "nn": art.nn_metrics})
    if args.plots and art.nn_telem is not None:
        _emit_dashboards(art.nn_telem, args.out, "NN_supervised")
        _emit_dashboards(art.mpc_telem, args.out, "MPC_baseline")


def cmd_surrogate(args):
    from .pipelines import generate_data, surrogate
    from .utils import checkpoint
    results_list = [generate_data.load(p)
                    for pat in args.data for p in sorted(glob.glob(pat))]
    if not results_list:
        raise SystemExit(f"surrogate: no dataset matches {args.data}")
    cfg = pcfg.SurrogateConfig(epochs=args.epochs, flags=_flags(args))
    art = surrogate.run(results_list, cfg, seed=args.seed,
                        eval_results=results_list[0], device=args.device)
    if args.save:
        checkpoint.save_surrogate(args.save, art.model, art.state_scaler)
    _emit({"test": art.test_metrics, "closed_loop": art.closed_loop_metrics})


def cmd_unsupervised(args):
    from .pipelines import generate_data, surrogate, unsupervised
    results = generate_data.load(args.data)
    s_cfg = pcfg.SurrogateConfig(epochs=args.surrogate_epochs,
                                 flags=_flags(args))
    s_art = surrogate.run([results], s_cfg, seed=args.seed,
                          device=args.device)
    cfg = pcfg.UnsupervisedConfig(horizon=args.horizon, epochs=args.epochs,
                                  train_mode=args.train_mode,
                                  n_seeds=args.seeds, flags=_flags(args))
    art = unsupervised.run(results, s_art.model, s_art.state_scaler, cfg,
                           seed=args.seed, closed_loop_eval=not args.no_eval,
                           out_dir=args.out, device=args.device)
    _emit({"test": art.test_metrics, "nn": art.nn_metrics,
           "surrogate_drift": art.surrogate_drift})
    if args.plots and art.nn_telem is not None:
        _emit_dashboards(art.nn_telem, args.out, "NN_unsupervised")


def main(argv=None):
    p = argparse.ArgumentParser(prog="forging_control_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--noise", action="store_true")
        sp.add_argument("--out", default="data")
        sp.add_argument("--plots", action="store_true",
                        help="write interactive HTML dashboards and PNGs to "
                             "<out>/Images/ (show_plots equivalent)")
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")

    g = sub.add_parser("generate", help="MPC dataset generation")
    common(g)
    g.add_argument("--n-traj", type=int, default=80)
    g.add_argument("--t-traj", type=int, default=300)
    g.add_argument("--horizon", type=int, default=25)
    g.add_argument("--random-refs", action="store_true")
    g.add_argument("--solver-preset", default="default",
                   choices=["default", "fast", "ipopt_compat"])
    g.add_argument("--trace", action="store_true",
                   help="record per-iteration solver traces")
    g.add_argument("--backend", default="auto",
                   choices=["auto", "sqp", "ilqr"],
                   help="solver backend (auto: condensed SQP for N<=12, "
                        "Riccati iLQR beyond)")
    g.add_argument("--export-pkl", action="store_true",
                   help="also write the dataset in the reference's do-mpc "
                        "pickle format (<dataset>.pkl)")
    g.set_defaults(fn=cmd_generate)

    sw = sub.add_parser("sweep", help="multi-horizon dataset sweep")
    common(sw)
    sw.add_argument("--horizons", type=int, nargs="+",
                    default=[5, 10, 15, 20, 25])
    sw.add_argument("--n-traj", type=int, default=80)
    sw.add_argument("--t-traj", type=int, default=300)
    sw.add_argument("--random-refs", action="store_true")
    sw.set_defaults(fn=cmd_sweep)

    sv = sub.add_parser("supervised", help="FNN imitation training + eval")
    common(sv)
    sv.add_argument("--data", required=True)
    sv.add_argument("--horizon", type=int, default=10)
    sv.add_argument("--epochs", type=int, default=20)
    sv.add_argument("--feasibility", action="store_true")
    sv.add_argument("--no-training", action="store_true")
    sv.add_argument("--no-eval", action="store_true")
    sv.add_argument("--seeds", type=int, default=1,
                    help="training replicas; best by closed-loop val MAE")
    sv.add_argument("--backend", default="auto",
                    choices=["auto", "sqp", "ilqr"],
                    help="MPC baseline solver backend (see generate)")
    sv.add_argument("--train-mode", default="imitation",
                    choices=["imitation", "dagger"],
                    help="imitation = reference one-shot cloning; dagger ="
                         " iterated imitation with batched MPC-teacher"
                         " relabelling (no plant fine-tune)")
    sv.set_defaults(fn=cmd_supervised)

    sg = sub.add_parser("surrogate", help="LSTM surrogate training")
    common(sg)
    sg.add_argument("--data", nargs="+", required=True)
    sg.add_argument("--epochs", type=int, default=50)
    sg.add_argument("--save", default=None)
    sg.set_defaults(fn=cmd_surrogate)

    us = sub.add_parser("unsupervised", help="MPC-loss controller training")
    common(us)
    us.add_argument("--data", required=True)
    us.add_argument("--horizon", type=int, default=10)
    us.add_argument("--epochs", type=int, default=20)
    us.add_argument("--surrogate-epochs", type=int, default=10)
    us.add_argument("--train-mode", choices=["surrogate", "plant", "dagger"],
                    default="surrogate",
                    help="surrogate: reference protocol (MPC loss through "
                         "the frozen LSTM); plant: policy gradients through "
                         "the true differentiable plant; dagger: iterated "
                         "imitation with batched MPC relabelling of the "
                         "student's own states")
    us.add_argument("--feasibility", action="store_true")
    us.add_argument("--no-eval", action="store_true")
    us.add_argument("--seeds", type=int, default=1,
                    help="training replicas; best by closed-loop val MAE")
    us.set_defaults(fn=cmd_unsupervised)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
