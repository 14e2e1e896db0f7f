"""Command-line entry points of the port.

Port of the ported subcommands of ``forging_control_tpu/cli.py``
(``:78-151``), with the same flags and the same single JSON line of
results, printed to standard output:

    python -m forging_control_tpu_torch generate  --n-traj 80 --horizon 25 --noise
    python -m forging_control_tpu_torch surrogate --data 'data/*.npz' --epochs 50

Every subcommand runs on ``--device`` (default ``cuda``; ``cpu`` only when
asked).  ``surrogate`` reads its files in ``sorted(glob)`` order per
pattern, as the JAX package's CLI does (so ``N_10`` comes before ``N_5``).
The other subcommands, ``--plots`` (``eval/html_dash``, ``eval/plots``)
and ``--export-pkl`` (``utils/dompc_pickle``) wait for their modules
(ROADMAP Queue A 11, 12, 14) and are refused with a message.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
import time

from .pipelines import config as pcfg


def _flags(args) -> pcfg.Flags:
    return pcfg.Flags(enable_noise=args.noise, silence_solver=True)


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def cmd_generate(args):
    from .pipelines import generate_data
    cfg = pcfg.GenerateConfig(
        n_traj=args.n_traj, t_traj=args.t_traj, horizon=args.horizon,
        solver_preset=args.solver_preset, record_trace=args.trace,
        backend=args.backend, flags=_flags(args))
    t0 = time.time()
    _, results = generate_data.run(
        cfg, seed=args.seed, exact_reference_streams=not args.random_refs,
        device=args.device)
    wall_s = time.time() - t0
    path = generate_data.dataset_path(args.out, cfg.horizon)
    generate_data.save(results, path)
    summ = generate_data.summarize(results)
    summ["backend"] = args.backend
    summ["wall_s"] = round(wall_s, 2)
    summ["solves"] = cfg.n_traj * cfg.t_traj
    _emit({"dataset": path, **summ})


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


def main(argv=None):
    p = argparse.ArgumentParser(prog="forging_control_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--noise", action="store_true")
        sp.add_argument("--out", default="data")
        sp.add_argument("--plots", action="store_true",
                        help="not ported yet (eval/html_dash, eval/plots)")
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
                   help="not ported yet (utils/dompc_pickle)")
    g.set_defaults(fn=cmd_generate)

    sg = sub.add_parser("surrogate", help="LSTM surrogate training")
    common(sg)
    sg.add_argument("--data", nargs="+", required=True)
    sg.add_argument("--epochs", type=int, default=50)
    sg.add_argument("--save", default=None)
    sg.set_defaults(fn=cmd_surrogate)

    args = p.parse_args(argv)
    if args.plots:
        p.error("--plots needs eval/html_dash and eval/plots, which the port "
                "does not have yet (ROADMAP Queue A 12)")
    if getattr(args, "export_pkl", False):
        p.error("--export-pkl needs utils/dompc_pickle, which the port does "
                "not have yet (ROADMAP Queue A 14)")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
