"""The benchmark's run: one cell of ``BENCHMARK.json``, found by name.

A cell names a configuration (``benchmark/configs/<config>.json``, the
file that ``BENCHMARK.json`` gives) and a traffic mix
(``benchmark/traffic/<traffic>.json``), whose ``driver`` key names the
module under ``benchmark/drivers/`` that runs it.  A per-layer metric is
``benchmark/metrics/<metric>.py``, whose ``read(rec)`` takes the traced
run's records and returns a number or None; the limits of the comparison
that decides ``correct`` are ``benchmark/limits/<cell>.json``.  Adding a
configuration, a traffic mix, a driver or a metric adds files and entries;
no file here names one.

A run: set-up (the program's first call, its captures; ``setup_s`` is from
the process's start to the first timed period), the measured window, the
look for JAX in ``sys.modules``, with ``--trace 1`` the traced stretch,
then the comparison, and one JSON line last on standard output.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "forging_control_tpu")
# The traced stretch lasts about this long untraced: a whole 300-period
# call of the AL-iLQR cells, a whole trajectory of the single stream, one
# SQP period (some 527,000 kernels).
TRACE_SECONDS = 1.0


class Refused(Exception):
    """The run cannot be made here; no result is printed."""


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def cell(root: Path, bench: dict, workload: str):
    """(workload entry, configuration, traffic, limits) of a cell."""
    try:
        wl = next(w for w in bench["workloads"] if w["name"] == workload)
    except StopIteration:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json") from None
    entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = read_json(root / entry["file"])
    traffic = read_json(root / "benchmark" / "traffic"
                        / f"{wl['traffic']}.json")
    limits = read_json(root / "benchmark" / "limits" / f"{workload}.json")
    return wl, cfg, traffic, limits


def entries(bench: dict, kind: str, workload: str) -> list:
    """The metrics of ``kind`` ("end_to_end", "per_layer") that the cell
    reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(root: Path, name: str):
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden() -> list:
    """The top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", "0"], capture_output=True, text=True, timeout=60,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        *, root: Path = ROOT, device=None, patch=None) -> dict:
    """One run of a cell; returns the result's JSON object.  ``device``
    None is the card (raises :class:`Refused` without enough of them);
    the tests pass "cpu" and ``patch``, a function that may change the
    configuration and traffic dicts (sizes) before the run."""
    import torch

    from . import check, trace as tracing
    from .spans import Spans

    spans = Spans()
    spans.add("start", t_start, time.perf_counter())

    bench = read_json(root / "BENCHMARK.json")
    wl, cfg, traffic, limits = cell(root, bench, workload)
    if patch is not None:
        patch(cfg, traffic)
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < wl["chips"]:
            raise Refused(f"{workload} needs {wl['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count()} available")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda":
        with spans("cuda_init"):
            torch.zeros(1, device=device)
            torch.cuda.synchronize(device)
    driver = importlib.import_module(f"benchmark.drivers.{traffic['driver']}")
    c = driver.Cell(cfg, traffic, seed, device, spans)
    c.setup()
    setup_s = time.perf_counter() - t_start
    e2e = c.window(seconds)
    e2e["setup_s"] = setup_s
    on_card = device.type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
           if on_card else 0}
    found = forbidden()
    if found:
        raise Refused(f"modules loaded that a run may not hold: {found}")
    attempted, failed = c.attempted_failed()
    out = {"correct": False, "attempted": attempted, "failed": failed}
    setup = {k: spans.total(k) for k in ("start", "cuda_init", "warmup")}
    if trace:
        rec = c.traced(TRACE_SECONDS)
        rec.update(spans=spans.items, cfg=cfg, traffic=traffic,
                   device=dev["kind"])
        metrics = {}
        for m in entries(bench, "per_layer", workload):
            v = reader(root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        dev.update(busy_s=tracing.busy_s(rec["ops"]),
                   window_s=rec["window_s"])
        out["breakdown"] = tracing.breakdown(rec)
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]}
                   for m in entries(bench, "end_to_end", workload)}
    out["metrics"] = metrics
    dev["power_limit"] = power_limit() if on_card else None
    out["device"] = dev
    torch.set_num_threads(1)
    found = check.gaps(cfg, c.streams(), traffic)
    out["correct"], out["checked"] = check.verdict(found, limits)
    spans.write(root / "build" / "benchmark"
                / f"spans-{workload}-{seed}-{int(trace)}.json")
    if forbidden():
        raise Refused(f"modules loaded that a run may not hold: "
                      f"{forbidden()}")
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in setup.items()),
          file=sys.stderr)
    return out


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json "
                                            "on the card.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start)
    except Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    for name, v in out["checked"].items():
        print(f"{name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0
