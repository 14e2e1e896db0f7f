"""Readings that the limits of ``benchmark/limits/<cell>.json`` are set
from: the compared numbers of sound runs of the program on many seeds, and
those of the precision control (the reference in bfloat16 in the program's
place), in one process, so that the set-up is paid once.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 \
        --control 3 --seconds <run_seconds> [--first-seed N]

Each seed is one run's window and one run's comparison (the cell's own
sizes and sample); the first ``--control`` seeds also read the control's
numbers on the same streams.  Prints one JSON line a seed, then a summary:
the largest reading of the program and the smallest of the control, per
number.  The benchmark's runs do not run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import check, harness  # noqa: E402
from benchmark.spans import Spans  # noqa: E402

CONTROL = torch.bfloat16


def readings(workload, seeds, control, seconds, device, patch=None):
    """Yields one dict a seed: the program's numbers and, for the first
    ``control`` seeds, the control's."""
    bench = harness.read_json(harness.ROOT / "BENCHMARK.json")
    _, cfg, traffic, limits = harness.cell(harness.ROOT, bench, workload)
    if patch is not None:
        patch(cfg, traffic)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    for i, seed in enumerate(seeds):
        c = driver.Cell(cfg, traffic, seed, device, Spans())
        c.setup()
        c.window(seconds)
        rows = c.streams()
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        t0 = time.perf_counter()
        got = check.gaps(cfg, rows, traffic)
        out = {"seed": seed, "rows": len(rows), "program": got,
               "program_correct": check.verdict(got, limits)[0],
               "check_s": time.perf_counter() - t0}
        if i < control:
            low = check.gaps(cfg, rows, traffic, dtype=CONTROL)
            out.update(control=low,
                       control_correct=check.verdict(low, limits)[0])
        torch.set_num_threads(n)
        yield out


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    seeds = [a.first_seed + 7919 * i for i in range(a.seeds)]
    lows, highs = {}, {}
    for r in readings(a.workload, seeds, a.control, a.seconds,
                      torch.device("cuda", 0)):
        print(json.dumps(r), flush=True)
        for k, v in r["program"].items():
            lows[k] = max(lows.get(k, 0.0), v)
        for k, v in r.get("control", {}).items():
            highs[k] = min(highs.get(k, float("inf")), v)
    print(json.dumps({"workload": a.workload, "program_max": lows,
                      "control_min": highs,
                      "device": torch.cuda.get_device_name(0),
                      "power_limit": harness.power_limit()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
