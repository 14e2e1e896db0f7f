"""Closed-loop MPC benchmark of the port: solves/s on one GPU.

Port of ``bench.py``'s ``run_bench`` (the JAX package's headline
benchmark): the full closed-loop engine (batched MPC solve + RK4 plant +
telemetry) over a scenario batch, reported as closed-loop MPC solves per
second.  Run it as ``python -m forging_control_tpu_torch.bench``; it prints
ONE JSON line with ``bench.py``'s keys (without XLA's cost-analysis fields)
plus ``device`` (the card's name and power limit), ``steps``, ``kernels``
(the hand-written kernels of the backend's path) with
``kernel_launches`` (their launches in one T-step run) and
``kernel_check``.

The kernels that run, per backend, on a card: the SQP launches its
Gauss-Newton build (``ops/sqp.py``), the small Cholesky solve B1
(``ops/smallchol.py``) and its line search gn x al times a step each; the
AL-iLQR launches its whole solve K5 (``ops/ilqr.py``) once a step; both
launch the plant step K4 (``ops/plant.py``) once a step.  On the CPU every
one of them runs its plain version.

Before it times anything, a run through the kernels (``linsolve="kernel"``)
takes one control step at B = 64 through the backend's kernel and through
its plain version on the same inputs and refuses to go on unless the
commands agree within 1e-4 (:func:`kernel_check`).

Env knobs, with ``bench.py``'s defaults: BENCH_BATCH (4096), BENCH_STEPS
(300), BENCH_HORIZON (10), BENCH_REPS (3), BENCH_BACKEND ("ilqr"; "sqp" for
the condensed GN-SQP, the path that runs the Cholesky kernel), BENCH_PRESET
(default: the qualified preset per horizon, read from
docs/RESULTS-parity.json, which this script never writes).  BENCH_PROFILE=1
adds a ``profile`` record (:func:`profile_run`): the device's busy share of
one run and its kernels by name.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import torch

from .device import resolve_device
from .loop.closed_loop import LoopConfig, MPCController, run_batch
from .ops import build
from .physics.press import X0_REFERENCE
from .refgen import streams
from .solver.sqp import MPCConfig

BASELINE = {"solves_per_s": 64.9, "horizon": 10,
            "source": "reference IPOPT median latency 15.402 ms, "
                      "BASELINE.md / MPC_results_N_10.csv"}

PARITY_JSON = Path(__file__).resolve().parents[1] / "docs" / \
    "RESULTS-parity.json"

PRESETS = {
    "default": MPCConfig,                       # 5 GN x 2 AL
    "teacher_6x2": lambda **kw: MPCConfig(gn_iters=6, al_iters=2, **kw),
    "fast": MPCConfig.fast,
    "fast_5x1": lambda **kw: MPCConfig.fast(gn_iters=5, **kw),
    "fast_6x1": lambda **kw: MPCConfig.fast(gn_iters=6, **kw),
    "fast_8x1": lambda **kw: MPCConfig.fast(gn_iters=8, **kw),
    "fast_4x2": lambda **kw: MPCConfig.fast(al_iters=2, **kw),
    "lean_4x2": lambda **kw: MPCConfig(gn_iters=4, al_iters=2, **kw),
    "lean_5x2": lambda **kw: MPCConfig(gn_iters=5, al_iters=2, **kw),
    "ipopt_compat": MPCConfig.ipopt_compat,
}


def _preset_default(n):
    """Headline preset per horizon: the speed preset whose wide-panel
    non-inferiority qualification holds at that horizon
    (docs/RESULTS-parity.json ``fast_preset_ab`` for N=10,
    ``fast_preset_by_horizon`` otherwise), else the 6x2 teacher."""
    try:
        parity = json.loads(PARITY_JSON.read_text())
        ab = (parity["fast_preset_ab"] if n == 10
              else parity["fast_preset_by_horizon"][f"N={n}"])
    except (OSError, KeyError, ValueError):
        return "teacher_6x2", ("no qualification artifact; 6x2 teacher "
                               "configuration")
    if ab.get("qualified"):
        art = ("fast_preset_ab" if n == 10
               else f"fast_preset_by_horizon[N={n}]")
        q = (f"{ab.get('preset')} preset non-inferior to the 6x2 "
             f"teacher default at N={n} on the {ab['n_streams']}-stream "
             f"wide panel: paired diff {ab['paired_diff_mean']:+.4f}, "
             f"one-sided 95% upper bound "
             f"{ab['noninferior_upper95']:+.4f} < pre-registered "
             f"+{ab['margin']} MAE margin, all trajectories finite; "
             f"docs/RESULTS-parity.json {art}")
        return ab.get("preset"), q
    return "teacher_6x2", (
        "no speed preset passed the wide-panel non-inferiority "
        "qualification at this horizon; runs the 6x2 teacher "
        "configuration itself (docs/RESULTS-parity.json "
        "fast_preset_ab / fast_preset_by_horizon)")


def device_info(device) -> dict:
    """The device's name and, for a card, its power limit as ``nvidia-smi``
    reports it (None if ``nvidia-smi`` cannot be run)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(index)],
            capture_output=True, text=True, timeout=60, check=True).stdout
        limit = out.strip().rsplit(",", 1)[-1].strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": torch.cuda.get_device_name(index), "power_limit": limit}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _runner(N, B, T, preset, backend, device, linsolve, seed, dtype):
    """A function that runs the benchmark's closed loop once and returns
    (Telemetry, wall seconds), synchronised on both ends."""
    loop_cfg = LoopConfig(t_steps=T, variant="smooth")
    ctrl = MPCController(PRESETS[preset](horizon=N, variant="smooth"),
                         backend=backend, linsolve=linsolve)
    gen = torch.Generator().manual_seed(seed)
    refs = streams.sample_references(gen, B, "supervised", t_steps=T,
                                     dtype=dtype, device=device)
    x0 = torch.tensor(X0_REFERENCE, dtype=dtype, device=device).repeat(B, 1)

    def run():
        _sync(device)
        t0 = time.perf_counter()
        _, telem = run_batch(loop_cfg, ctrl, x0, refs, device=device)
        _sync(device)
        return telem, time.perf_counter() - t0
    return run


CHECK_BATCH = 64
CHECK_TOL = 1e-4       # commands are O(0.1); the closed loop damps rounding
# Where a solve turns rounding into other accepted steps, the share of
# scenarios in which the kernel parts from a reference may exceed the
# plain version's share by this much (PERF.md, K5's findings).
SHARE_SLACK = 0.02


def far_share(a, b, tol) -> float:
    """Share of the scenarios (leading axis) where ``a`` and ``b`` part by
    more than ``tol`` anywhere."""
    far = ((a - b).abs() > tol).reshape(a.shape[0], -1).any(1)
    return float(far.double().mean())

# The hand-written kernels of each backend's path on a card.
KERNELS = {"sqp": ("sqp_build", "chol_solve", "sqp_search", "plant"),
           "ilqr": ("ilqr", "plant")}
# The record's name of each of those kernels, and its name in
# ``build.LAUNCHES``.
_WRAPPERS = {"chol_solve": "smallchol", "ilqr": "ilqr", "plant": "plant",
             "sqp_build": "sqp_build", "sqp_search": "sqp_search"}


def _launches() -> dict:
    return {k: build.LAUNCHES[name] for k, name in _WRAPPERS.items()}


def _since(before: dict) -> dict:
    return {k: n - before[k] for k, n in _launches().items()}


def kernel_check(N, preset, *, backend="sqp", device="cuda", seed=0,
                 dtype=torch.float32) -> dict:
    """One control step of the closed loop at B = ``CHECK_BATCH`` through
    the backend's kernel and through its plain version
    (``linsolve="plain"``: the plain Cholesky solve for the SQP, the tensor
    code of the whole solve for the AL-iLQR), from the same states and
    references; the plant step is K4 in both.  Returns the largest command
    gap, the tolerance and the kernels' launches; raises if the gap exceeds
    ``CHECK_TOL`` or a command is not finite.

    The AL-iLQR's kernel and plain version differ in the order of their
    sums, and a float32 solve turns that into other accepted steps where
    the line search's costs lie within float32 rounding: at N = 5 and 25
    the plain float32 solve itself lies more than ``CHECK_TOL`` from the
    float64 one (PERF.md, K5's findings).  So where the float32 commands of the two
    differ by more than ``CHECK_TOL``, the AL-iLQR check holds the kernel
    to the float64 plain solve instead: the share of scenarios whose
    command lies more than ``CHECK_TOL`` from it may exceed the plain
    float32 solve's share by at most ``SHARE_SLACK``."""
    device = resolve_device(device)
    cfg = PRESETS[preset](horizon=N, variant="smooth")
    refs = streams.sample_references(torch.Generator().manual_seed(seed),
                                     CHECK_BATCH, "supervised", t_steps=1,
                                     dtype=dtype, device=device)
    x0 = torch.tensor(X0_REFERENCE, dtype=dtype,
                      device=device).repeat(CHECK_BATCH, 1)

    def step(linsolve, dt=dtype):
        return run_batch(LoopConfig(t_steps=1, variant="smooth"),
                         MPCController(cfg, backend=backend,
                                       linsolve=linsolve), x0.to(dt),
                         refs.to(dt), device=device)[1].u

    before = _launches()
    u = {ls: step(ls) for ls in ("kernel", "plain")}
    du = float((u["kernel"] - u["plain"]).abs().max())
    rec = {"batch": CHECK_BATCH, "steps": 1, "backend": backend,
           "max_abs_du": du, "tolerance": CHECK_TOL}
    ok = du <= CHECK_TOL
    if not ok and backend == "ilqr" and dtype != torch.float64:
        u64 = step("plain", torch.float64)
        far = {k: far_share(v.double(), u64, CHECK_TOL) for k, v in u.items()}
        rec["float64_reference"] = {"kernel_far_share": far["kernel"],
                                    "plain_far_share": far["plain"]}
        ok = far["kernel"] <= far["plain"] + SHARE_SLACK
    rec["kernel_launches"] = _since(before)
    if not (bool(torch.isfinite(u["kernel"]).all()) and ok):
        raise RuntimeError(f"kernel check failed: the {backend} kernel and "
                           f"plain paths' commands differ by {du:.3e} at "
                           f"B = {CHECK_BATCH} (tolerance {CHECK_TOL}"
                           + (f"; against float64 "
                              f"{rec['float64_reference']}"
                              if "float64_reference" in rec else "") + ")")
    return rec


def run_bench(N, B, T, reps, preset, backend, *, device="cuda",
              linsolve="kernel", seed=0, dtype=torch.float32):
    """Time ``reps`` closed-loop runs of T steps over B scenarios after one
    warm-up run; returns the JSON record (best run).  Through the kernels
    (``linsolve="kernel"``), :func:`kernel_check` passes first."""
    device = resolve_device(device)
    check = None
    if linsolve == "kernel":
        check = kernel_check(N, preset, backend=backend, device=device,
                             seed=seed, dtype=dtype)
    run = _runner(N, B, T, preset, backend, device, linsolve, seed, dtype)

    # Warm-up (first-call set-up: kernel build and load, library handles);
    # its kernel launches are the per-run count.
    before = _launches()
    telem, _ = run()
    launches = _since(before)
    if not bool(torch.isfinite(telem.u).all()):
        raise RuntimeError("non-finite commands")

    best = min(run()[1] for _ in range(reps))
    solves_per_s = (B * T) / best
    per = "chip" if device.type == "cuda" else "CPU run"
    rec = {
        "metric": f"closed-loop MPC solves/s/{per} (N={N}, batch={B})",
        "value": round(solves_per_s, 1),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE["solves_per_s"], 2),
        "baseline": BASELINE,
        "preset": preset,
        "backend": backend,
        "linsolve": linsolve,
        "steps": T,
        "device": device_info(device),
        "kernels": list(KERNELS[backend]),
        "kernel_launches": launches,
        "kernel_check": check,
    }
    if N != 10:
        rec["vs_baseline_note"] = (
            "baseline latency tables exist only at N=10; this ratio "
            f"compares N={N} solves against the N=10 baseline rate")
    return rec


def profile_run(N, B, T, preset, backend, *, device="cuda",
                linsolve="kernel", seed=0, dtype=torch.float32, top=8):
    """Where one closed-loop run's time goes on the card.

    After a warm-up run, times one run without the profiler (``wall_s``),
    then traces one more with ``torch.profiler`` and sums the device time of
    its kernels (the union of their intervals, ``device_busy_s``).  The busy
    share is that sum over the untraced wall time, so the tracer's own host
    cost does not dilute it.  Also returns the kernel count per control step
    and the ``top`` kernels by device time.
    """
    from torch.profiler import ProfilerActivity, profile

    device = resolve_device(device)
    if device.type != "cuda":
        raise ValueError("profile_run measures a card; got device "
                         f"{device}")
    run = _runner(N, B, T, preset, backend, device, linsolve, seed, dtype)
    run()
    _, wall = run()
    # Device activity only: a step is some 10^5 host ops, and tracing them
    # too would multiply the trace without adding to these sums.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    rec = device_busy(prof, wall, top)
    return {"steps": T, **rec, "kernels_per_step": rec["kernels"] / T}


def device_busy(prof, wall_s: float, top: int = 8) -> dict:
    """Device time of a ``torch.profiler`` trace: the union of its CUDA
    kernels' intervals (``device_busy_s``), that sum over ``wall_s`` (an
    untraced run's wall time, so the tracer's host cost does not dilute
    it), the kernel count, the mean kernel time, and the ``top`` kernels by
    device time.

    It reads the trace's raw Kineto events: ``prof.events()`` builds a
    Python object per event, about 75 us each, which is more than a minute
    for the million kernels of one eager control step."""
    from torch.autograd import DeviceType

    spans = sorted((e.start_ns() / 1e3, e.end_ns() / 1e3, e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for t0, t1, name in spans:
        busy_us += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name][0] += 1
        by_name[name][1] += t1 - t0
    busy_s = busy_us / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "wall_s": wall_s,
        "device_busy_s": busy_s,
        "device_busy_share": busy_s / wall_s,
        "kernels": len(spans),
        "mean_kernel_us": busy_us / max(1, len(spans)),
        "top_kernels": [{"name": n[:80], "count": c, "ms": us / 1e3}
                        for n, (c, us) in ranked],
    }


def main():
    B = int(os.environ.get("BENCH_BATCH", 4096))
    T = int(os.environ.get("BENCH_STEPS", 300))
    N = int(os.environ.get("BENCH_HORIZON", 10))
    reps = int(os.environ.get("BENCH_REPS", 3))
    preset = os.environ.get("BENCH_PRESET")
    if preset:
        quality = f"preset forced via BENCH_PRESET={preset}"
    else:
        preset, quality = _preset_default(N)
    backend = os.environ.get("BENCH_BACKEND", "ilqr")
    rec = run_bench(N, B, T, reps, preset, backend)
    rec["quality"] = quality
    if os.environ.get("BENCH_PROFILE") == "1":
        rec["profile"] = profile_run(N, B, T, preset, backend)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
