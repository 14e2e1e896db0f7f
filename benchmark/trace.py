"""The traced part of a ``--trace 1`` run: ``torch.profiler`` around a
short stretch of the cell's own work, read into plain records.

The device's operations come from the trace's raw Kineto events (building
the profiler's Python event objects costs some 75 us an event, more than a
minute for the half million kernels of one SQP period).  Busy time is the
union of their intervals; the idle gaps between them are named by what the
host was doing at their middle: the innermost host range (an operator of
the program or a span of the harness) that covers it.  The profiler slows
what it traces (an SQP period of some 527,000 kernels took 1.2 s traced
against 0.7 s untraced on an H100), so shares are taken within the traced
stretch and not against an untraced run's time.
"""

from __future__ import annotations

import collections
import time

TOP = 10


def record(fn) -> dict:
    """Run ``fn()`` under the profiler (host and device activity) and
    return ``{"window_s", "ops": [(name, start_s, end_s), ...] on the
    device, "host": [(name, start_s, end_s), ...]}``; ``fn`` must end by
    synchronising the device."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        window = time.perf_counter() - t0
    ops, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() / 1e9, e.end_ns() / 1e9)
        if e.device_type() == DeviceType.CUDA:
            # A host range (record_function) is mirrored on the device's
            # timeline; it is no operation of the device.
            if not getattr(e, "is_user_annotation", lambda: False)():
                ops.append(item)
        elif e.device_type() == DeviceType.CPU:
            host.append(item)
    ops.sort(key=lambda o: o[1])
    return {"window_s": window, "ops": ops, "host": host}


def is_kernel(name: str) -> bool:
    """A kernel, as opposed to a copy or a fill the device also runs."""
    return not name.startswith(("Memcpy", "Memset"))


def busy_intervals(ops) -> list:
    """The union of the operations' intervals, in order."""
    out = []
    for _, t0, t1 in ops:
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def busy_s(ops) -> float:
    return sum(t1 - t0 for t0, t1 in busy_intervals(ops))


def breakdown(rec: dict) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by what the host was doing, each at most ``TOP`` entries of
    [name, seconds]."""
    by_op = collections.Counter()
    for name, t0, t1 in rec["ops"]:
        by_op[name[:120]] += t1 - t0
    gaps = collections.Counter()
    spans = busy_intervals(rec["ops"])
    host = sorted(rec["host"], key=lambda h: h[1])
    active, i = [], 0
    for (_, end), (start, _) in zip(spans, spans[1:]):
        mid = 0.5 * (end + start)       # the gaps come in order of time
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        name = min(active, key=lambda h: h[2] - h[1])[0] if active \
            else "no host range"
        gaps[name[:120]] += start - end
    return {"device_ops": [[n, s] for n, s in by_op.most_common(TOP)],
            "idle_gaps": [[n, s] for n, s in gaps.most_common(TOP)]}
