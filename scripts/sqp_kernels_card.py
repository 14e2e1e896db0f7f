#!/usr/bin/env python3
"""The condensed GN-SQP's build and search kernels on one NVIDIA GPU.

Builds ``csrc/sqp_build.cu`` and ``csrc/sqp_search.cu`` (printing ptxas's
registers and spills), holds ``solver.sqp.solve_batch`` through the kernels
(``linsolve="kernel"``: build, B1, search a Gauss-Newton iteration) against
its plain tensor code on the same card (``linsolve="plain"``), then times
the kernels alone at B = 4,096, N = 10 (``fast_5x1``, float32): each
launch's device time from CUDA graphs of k launches replayed between two
CUDA events (as ``chip_smoke.py``'s ``graph_ms``), for each team size, and
a whole solve; and counts one captured closed-loop period's launches (the
launch count ``ops.build.LAUNCHES`` and a traced replay).
Imports neither jax nor the JAX package.

    python3 scripts/sqp_kernels_card.py [--out FILE]

Prints one JSON line per phase and writes them all to ``--out`` (default
``chiprun_out/sqp_kernels_card.json``).  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from forging_control_tpu_torch.loop import closed_loop as cl  # noqa: E402
from forging_control_tpu_torch.ops import build, smallchol  # noqa: E402
from forging_control_tpu_torch.ops import sqp as sqp_ops  # noqa: E402
from forging_control_tpu_torch.physics import press  # noqa: E402
from forging_control_tpu_torch.solver import sqp  # noqa: E402

RECORDS = []


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def inputs(B, N, nc, dtype, seed, warm=None):
    """States of the closed loop's strokes around the reference state (y in
    [0, 0.05] m, y_dot in [0, 0.3] m/s, pressures within 1 %), references
    in [0.1, 0.9] for the first half of the rows and [-0.9, -0.1] for the
    second (work and return strokes), previous commands in [-0.1, 0.1]; a
    cold start (zeros) or, where ``warm`` is an MPCConfig, a warm one (its
    plain float64 solve's shifted solution from these states, then the
    states moved by 1 %), on the card."""
    g = torch.Generator().manual_seed(seed)
    f64 = torch.float64
    x0 = torch.tensor(press.X0_REFERENCE, dtype=f64).repeat(B, 1)
    x0 = x0 * (1.0 + 0.01 * torch.randn(x0.shape, generator=g, dtype=f64))
    x0[:, 0] = torch.empty(B, dtype=f64).uniform_(0.0, 0.05, generator=g)
    x0[:, 1] = torch.empty(B, dtype=f64).uniform_(0.0, 0.3, generator=g)
    ref = torch.empty(B, dtype=f64).uniform_(0.1, 0.9, generator=g)
    ref[B // 2:] = -ref[B // 2:]
    up = torch.empty(B, dtype=f64).uniform_(-0.1, 0.1, generator=g)
    v = torch.zeros(B, N, dtype=f64)
    lam = torch.zeros(B, nc * N, dtype=f64)
    out = [a.to("cuda") for a in (x0, ref, up, v, lam)]
    if warm:
        u, st, _ = solve(warm, *out, "plain")
        st = sqp.shift_state(st)
        x0 = x0 * (1.0 + 0.01 * torch.randn(x0.shape, generator=g,
                                            dtype=f64))
        out = [x0.to("cuda"), out[1], u, st.v, st.lam]
    return tuple(a.to(dtype) for a in out)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})


def phase_build():
    t0 = time.perf_counter()
    built = build.build_all(("smallchol", "plant") + sqp_ops.SOURCES)
    regs = {}
    for name in sqp_ops.SOURCES:
        entry = None
        for line in built[name].log.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                regs.setdefault(name, {})[entry] = {
                    "registers": int(m.group(1))}
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry:
                regs.setdefault(name, {}).setdefault(entry, {})["spill"] = [
                    int(m.group(1)), int(m.group(2))]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "compile_s": {n: b.seconds for n, b in built.items()},
          "ptxas": regs})


CASES = (
    # name, MPCConfig, B, warm
    ("fast_5x1 N10", sqp.MPCConfig.fast(horizon=10, gn_iters=5,
                                        variant="smooth"), 256, False),
    ("teacher_6x2 pmax N10 trace", sqp.MPCConfig(
        horizon=10, gn_iters=6, al_iters=2, p_max=32e6, variant="smooth",
        record_trace=True), 256, False),
    ("5x2 ladder3 N2", sqp.MPCConfig(horizon=2, variant="raw",
                                     step_ladder=(1.0, 0.5, 0.25)), 64, False),
    ("fast N12 warm", sqp.MPCConfig.fast(horizon=12, gn_iters=5,
                                         variant="clamp"), 256, True),
    ("5x2 N25 warm", sqp.MPCConfig(horizon=25, variant="smooth"), 128, True),
    ("gn0 al2 N5", sqp.MPCConfig(horizon=5, gn_iters=0, al_iters=2), 37,
     True),
    ("polish N5", sqp.MPCConfig(horizon=5, polish_iters=2, p_max=32e6), 37,
     True),
)


def solve(cfg, x0, ref, up, v, lam, linsolve):
    return sqp.solve_batch(cfg, x0, ref, up, sqp.SolverState(v, lam),
                           linsolve=linsolve)


def far(a, b, tol):
    """Share of the rows where a and b part by more than tol."""
    return float(((a.double() - b.double()).abs() > tol).double().mean())


def phase_check() -> bool:
    """Kernel against plain on the card.  Float64: u0 within 1e-9, or
    beyond it at most 2 % of the rows, or at most 2 points more than where
    the plain solve on the card and on the CPU part (K5's share rule: a
    solve turns rounding into other accepted steps where candidate costs
    tie).  Float32
    against the float64 plain solve: the share of rows whose u0 lies more
    than 1e-3 (benchmark/check.py's SQP limits) from it may exceed the plain
    float32 solve's share by at most 2 %."""
    ok_all = True
    for name, cfg, B, warm in CASES:
        nc = 2 if cfg.p_max is None else 4
        t64 = inputs(B, cfg.horizon, nc, torch.float64, 7,
                     cfg if warm else None)
        t32 = tuple(a.float() for a in t64)
        u64k, s64k, d64k = solve(cfg, *t64, "kernel")
        u64p, s64p, d64p = solve(cfg, *t64, "plain")
        u32k, _, _ = solve(cfg, *t32, "kernel")
        u32p, _, _ = solve(cfg, *t32, "plain")
        torch.cuda.synchronize()
        def gap(a, b):
            return float((a.double() - b.double()).abs().max())
        rec = {"phase": "check", "case": name, "B": B,
               "f64_u0": gap(u64k, u64p), "f64_v": gap(s64k.v, s64p.v),
               "f64_lam": gap(s64k.lam, s64p.lam),
               "f64_obj": gap(d64k.obj, d64p.obj),
               "f64_iters_equal": float((d64k.iters == d64p.iters)
                                        .double().mean()),
               "f64_far_1e-9": far(u64k, u64p, 1e-9),
               "f32_kernel_far_1e-3": far(u32k, u64p, 1e-3),
               "f32_plain_far_1e-3": far(u32p, u64p, 1e-3),
               "f32_kernel_u0_vs_f64": gap(u32k, u64p),
               "f32_plain_u0_vs_f64": gap(u32p, u64p),
               "finite": all(bool(torch.isfinite(a).all())
                             for a in (u64k, u32k))}
        if cfg.record_trace:
            rec["f64_trace"] = gap(d64k.trace, d64p.trace)
        ok64 = rec["f64_u0"] <= 1e-9 or rec["f64_far_1e-9"] <= 0.02
        if not ok64:
            # Where the solve turns rounding into other accepted steps (N =
            # 25), the plain solve on the card parts from the plain solve on
            # the CPU too: the kernel may part from the former in at most 2
            # points more of the rows (chip_smoke.py 3c's rule for K5).
            u64c, _, _ = solve(cfg, *(a.cpu() for a in t64), "plain")
            rec["f64_plain_card_cpu_far_1e-9"] = far(u64p.cpu(), u64c, 1e-9)
            ok64 = rec["f64_far_1e-9"] <= \
                rec["f64_plain_card_cpu_far_1e-9"] + 0.02
        ok = rec["finite"] and ok64 \
            and rec["f32_kernel_far_1e-3"] <= rec["f32_plain_far_1e-3"] + 0.02
        rec["ok"] = ok
        ok_all &= ok
        emit(rec)
    return ok_all


def graph_ms(fn, k=50, replays=10):
    """Device ms a call: k calls captured in one CUDA graph (after a
    warm-up), replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(k):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (replays * k)


def phase_time(B=4096, N=10):
    """Each kernel alone at B = 4,096 on the inputs of one Gauss-Newton
    iteration (the first of a cold solve), by team size; the teams give
    the same bits."""
    cfg = sqp.MPCConfig.fast(horizon=N, gn_iters=5, variant="smooth")
    x0, ref, up, v, lam = inputs(B, N, 2, torch.float32, 11)
    kcfg = sqp.kernel_cfg(cfg, N)
    bufs = sqp_ops.allocate(kcfg, v)
    step = sqp_ops.schedule(cfg.al_iters, cfg.gn_iters)[0]
    sqp_ops.sqp_build_cuda(kcfg, cfg.params, x0, ref, up, v, lam, bufs, step)
    x = smallchol.chol_solve_cuda(bufs.H.view(3 * B, N, N),
                                  bufs.g.view(3 * B, N)).view(B, 3, N)
    ref_H, ref_x = bufs.H.clone(), x.clone()
    rec = {"phase": "time", "B": B, "N": N, "build_ms": {}, "search_ms": {}}
    for G in (N, 16, 32):
        fn = lambda G=G: sqp_ops.sqp_build_cuda(  # noqa: E731
            kcfg, cfg.params, x0, ref, up, v, lam, bufs, step, team=G)
        rec["build_ms"][G] = graph_ms(fn)
        rec.setdefault("build_bitwise", {})[G] = bool(torch.equal(bufs.H,
                                                                  ref_H))
    rec["b1_ms"] = graph_ms(lambda: smallchol.chol_solve_cuda(
        bufs.H.view(3 * B, N, N), bufs.g.view(3 * B, N)))
    out = {}
    for S in (4, 8, 32):
        fn = lambda S=S: sqp_ops.sqp_search_cuda(  # noqa: E731
            kcfg, cfg.params, x0, ref, up, v, lam, ref_x, bufs, step,
            team=S)
        rec["search_ms"][S] = graph_ms(fn)
        out[S] = bufs.out.v.clone()
    rec["search_bitwise"] = all(torch.equal(o, out[4]) for o in out.values())
    # One whole solve (5 x (build, B1, search)) captured.
    rec["solve_ms"] = graph_ms(lambda: solve(cfg, x0, ref, up, v, lam,
                                             "kernel"), k=5)
    emit(rec)


def phase_period(T=4, B=4096):
    """The benchmark's closed loop (fast_5x1, N = 10, float32, B = 4,096,
    T periods): a first run captures, a second replays; the replayed run's
    launches by the launch count, and a traced replay's device kernels."""
    from torch.profiler import ProfilerActivity, profile
    cfg = sqp.MPCConfig.fast(horizon=10, gn_iters=5, variant="smooth")
    ctrl = cl.MPCController(cfg)
    loop = cl.LoopConfig(t_steps=T, variant="smooth",
                         process_std=(0.5, 2.0, 5e7, 5e7, 2.0))
    x0 = torch.tensor(press.X0_REFERENCE, dtype=torch.float32,
                      device="cuda").repeat(B, 1)
    refs = torch.full((B, T), 0.3, device="cuda")
    noise = 1e-3 * torch.randn(B, T, 5, device="cuda")
    run = lambda: cl.run_batch(loop, ctrl, x0, refs,  # noqa: E731
                               process_noise=noise, device="cuda")
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    before = build.LAUNCHES.copy()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    second = time.perf_counter() - t0
    launches = build.LAUNCHES - before
    period = cl.cached_period(loop, ctrl, B, torch.float32, "cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    by = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        key = next((k for k in ("sqp_build_kernel", "sqp_search_kernel",
                                "chol_solve_kernel", "plant")
                    if k in e.name()), "other")
        d = by.setdefault(key, [0, 0.0])
        d[0] += 1
        d[1] += (e.end_ns() - e.start_ns()) / 1e6
    emit({"phase": "period", "B": B, "T": T, "first_run_s": first,
          "replayed_run_s": second, "s_per_period": second / T,
          "solves_per_s_replayed": B * T / second,
          "stats": {k: v for k, v in period.stats.items()},
          "launches_per_run": {"sqp_build": launches["sqp_build"],
                               "sqp_search": launches["sqp_search"],
                               "chol_solve": launches["smallchol"]},
          "traced_kernels": len(names),
          "traced_kernels_per_period": len(names) / T,
          "traced_ms_by_kernel": by})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "chiprun_out"
                                         / "sqp_kernels_card.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sqp_kernels_card: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    phase_device()
    phase_build()
    ok = phase_check()
    phase_time()
    phase_period()
    emit({"phase": "end", "ok": ok, "seconds": time.perf_counter() - t0})
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(RECORDS, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    np.seterr(all="ignore")
    sys.exit(main())
