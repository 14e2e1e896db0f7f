#!/usr/bin/env python3
"""Kernel K5 (the whole AL-iLQR solve) by team size on one NVIDIA GPU.

Builds ``csrc/ilqr.cu`` (printing ptxas's registers and spills of each
instantiation), holds every team size's outputs bitwise against G = 8's
(and the size ``ops.ilqr.team_size`` picks, where the tree has the rule),
then times K5 alone: each launch's device time from CUDA events around
``--launches`` launches, in ``--turns`` turns over the team sizes, at
B = 1, 64, 256, 1,024, 2,048, 4,096, G = 8, 16, 32, N = 10 (``fast_5x1``)
and N = 25 (the default 5 x 2), float32, both strokes (references in
[0.05, 0.65] and their negatives), from a cold start at the reference
state.  Imports neither jax nor the JAX package.

    python3 scripts/k5_team_card.py [--root DIR] [--out FILE]
        [--save FILE] [--compare FILE]

``--root`` runs the package of another checkout (a parent commit unpacked
beside this one), whose ``ilqr_cuda`` takes ``team=``; ``--save`` writes
G = 8's outputs to an npz file, and ``--compare`` holds this tree's outputs
at every G bitwise against such a file.  Prints one JSON line per record
and writes them all to ``--out`` (default
``chiprun_out/k5_team_card.json``).  Exits non-zero if a check fails.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
parser.add_argument("--out", default="chiprun_out/k5_team_card.json")
parser.add_argument("--save")
parser.add_argument("--compare")
parser.add_argument("--launches", type=int, default=20)
parser.add_argument("--turns", type=int, default=2)
parser.add_argument("--batches", default="1,64,256,1024,2048,4096")
ARGS = parser.parse_args()
sys.path.insert(0, str(Path(ARGS.root).resolve()))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from forging_control_tpu_torch import bench  # noqa: E402
from forging_control_tpu_torch.ops import build, ilqr  # noqa: E402
from forging_control_tpu_torch.physics import press  # noqa: E402
from forging_control_tpu_torch.solver import riccati  # noqa: E402

RECORDS = []
TEAMS = (8, 16, 32)
FIELDS = ("u0", "v", "lam", "iters", "obj", "inf_pr", "inf_du", "reg",
          "d_norm", "mu", "alpha", "trace")


def emit(rec: dict) -> None:
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def config(N: int, trace: bool = False):
    if N == 10:
        return bench.PRESETS["fast_5x1"](horizon=10, variant="smooth",
                                         record_trace=trace)
    return riccati.MPCConfig(horizon=N, variant="smooth", record_trace=trace)


def inputs(B: int, N: int, stroke: str, seed: int = 10):
    """A cold start at the reference state, float32, on the card."""
    refs = np.random.default_rng(seed).uniform(0.05, 0.65, B)
    sign = 1.0 if stroke == "work" else -1.0
    dev, f32 = "cuda", torch.float32
    x0 = torch.tensor(press.X0_REFERENCE, dtype=f32, device=dev).repeat(B, 1)
    ref = torch.tensor(sign * refs, dtype=f32, device=dev)
    return (x0, ref, torch.zeros(B, dtype=f32, device=dev),
            torch.zeros(B, N, dtype=f32, device=dev),
            torch.zeros(B, N, 2, dtype=f32, device=dev))


def launch(cfg, args, team):
    return ilqr.ilqr_cuda(riccati.kernel_cfg(cfg, cfg.horizon), cfg.params,
                          *args, team=team)


def ptxas() -> None:
    """Registers, stack and spills of each instantiation of the kernel."""
    entry, rows = None, {}
    for line in build.load("ilqr").log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"ilqr_kernelI([fd])Li(\d+)E", m.group(1))
            kind = k and ("float" if k.group(1) == "f" else "double")
            entry = f"{kind} G={k.group(2)}" if k else None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            rows[entry] = {"stack_B": int(m.group(1)),
                           "spill_stores_B": int(m.group(2)),
                           "spill_loads_B": int(m.group(3))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows[entry]["registers"] = int(m.group(1))
            entry = None
    emit({"phase": "ptxas", "seconds": build.load("ilqr").seconds, **rows})


def bits() -> bool:
    """Every G's outputs (and the rule's) against G = 8's; with --save and
    --compare, G = 8's of another tree."""
    ok, saved = True, {}
    other = dict(np.load(ARGS.compare)) if ARGS.compare else {}
    for N in (10, 25):
        for B in (1, 256, 4096):
            for stroke, trace in (("work", True), ("return", False)):
                cfg = config(N, trace)
                args = inputs(B, N, stroke)
                want = launch(cfg, args, 8)
                key = f"N{N}_B{B}_{stroke}"
                teams = list(TEAMS)
                rule = None
                if hasattr(ilqr, "team_size"):
                    rule = ilqr.team_size(B, N, torch.float32,
                                          ilqr.sm_count(0))
                    teams.append(None)
                same = {}
                for G in teams:
                    got = launch(cfg, args, G)
                    same["rule" if G is None else G] = all(
                        (a is None and b is None) or torch.equal(a, b)
                        for a, b in zip(got, want))
                for f, a in zip(FIELDS, want):
                    if a is not None:
                        saved[f"{key}.{f}"] = a.cpu().numpy()
                if other:
                    same["other_tree_G8"] = all(
                        np.array_equal(saved[f"{key}.{f}"],
                                       other[f"{key}.{f}"])
                        for f in FIELDS if f"{key}.{f}" in saved)
                ok = ok and all(same.values())
                emit({"phase": "bits", "case": key, "rule": rule,
                      "bitwise_equal_to_G8": same})
    if ARGS.save:
        np.savez(ARGS.save, **saved)
    return ok


def timings() -> None:
    """Device ms a launch, turns of --launches launches over G."""
    batches = [int(b) for b in ARGS.batches.split(",") if b]
    for N in (10, 25):
        cfg = config(N)
        for stroke in ("work", "return"):
            for B in batches:
                args = inputs(B, N, stroke)
                ms = {G: [] for G in TEAMS}
                for G in TEAMS:   # warm-up: load, opt in, first launch
                    launch(cfg, args, G)
                torch.cuda.synchronize()
                for _ in range(ARGS.turns):
                    for G in TEAMS:
                        start = torch.cuda.Event(enable_timing=True)
                        end = torch.cuda.Event(enable_timing=True)
                        start.record()
                        for _ in range(ARGS.launches):
                            launch(cfg, args, G)
                        end.record()
                        end.synchronize()
                        ms[G].append(start.elapsed_time(end) / ARGS.launches)
                rule = (ilqr.team_size(B, N, torch.float32, ilqr.sm_count(0))
                        if hasattr(ilqr, "team_size") else None)
                emit({"phase": "time", "N": N, "stroke": stroke, "B": B,
                      "rule": rule,
                      "ms": {str(G): [round(t, 5) for t in v]
                             for G, v in ms.items()}})


def main() -> int:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    emit({"phase": "device", "nvidia_smi": smi, "root": ARGS.root,
          "torch": torch.__version__, "sms": torch.cuda.get_device_properties(
              0).multi_processor_count})
    ptxas()
    ok = bits()
    timings()
    emit({"phase": "end", "ok": ok})
    Path(ARGS.out).parent.mkdir(parents=True, exist_ok=True)
    Path(ARGS.out).write_text(json.dumps(RECORDS, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
