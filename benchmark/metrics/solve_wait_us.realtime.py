"""solve_wait_us.realtime: how long the card waits each period after the
program is entered: the mean, over the program's ``stepper`` spans, of the
time from a span's start to the start of the first K5 launch after it and
before the next span, in microseconds.  Both on the profiler's clock.  None
where the trace holds no such span or no K5 launch."""

import bisect

from benchmark.metrics_lib import K5_NAME


def read(rec):
    starts = sorted(t0 for name, t0, _ in rec["host"] if name == "stepper")
    k5 = [t0 for name, t0, _ in rec["ops"] if K5_NAME in name]
    waits = []
    for s, until in zip(starts, starts[1:] + [float("inf")]):
        i = bisect.bisect_left(k5, s)
        if i < len(k5) and k5[i] < until:
            waits.append(k5[i] - s)
    return 1e6 * sum(waits) / len(waits) if waits else None
