"""stepper_host_us.realtime: the mean length, in microseconds, of the
program's ``stepper`` spans in the traced stretch: one call of the single
stream's stepper (its inputs' writes, the graph's launch, the copy of the
command), as the profiler stamped the range.  None where the program has
no such span."""


def read(rec):
    spans = [t1 - t0 for name, t0, t1 in rec["host"] if name == "stepper"]
    return 1e6 * sum(spans) / len(spans) if spans else None
