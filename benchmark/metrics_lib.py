"""Arithmetic that several per-layer metrics share."""

from __future__ import annotations

from . import trace
from .work import k5, peaks

K5_NAME = "ilqr_kernel"


def k5_roofline(rec):
    times = [t1 - t0 for name, t0, t1 in rec["ops"] if K5_NAME in name]
    if not times:
        return None
    work = k5.count(rec["cfg"], rec["batch"],
                    4 if rec["cfg"]["dtype"] == "float32" else 8)
    least = peaks.least_time(work["ops"], work["bytes"], rec["cfg"]["dtype"])
    return 100.0 * least / (sum(times) / len(times))


def device_idle_pct(rec):
    if not rec["ops"]:
        return None
    return 100.0 * (1.0 - trace.busy_s(rec["ops"]) / rec["window_s"])
