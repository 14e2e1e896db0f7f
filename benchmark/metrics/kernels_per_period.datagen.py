"""kernels_per_period.datagen: the device's kernels (copies and fills
left out) in the traced stretch of a batched cell, over its periods."""

from benchmark import trace


def read(rec):
    n = sum(1 for name, _, _ in rec["ops"] if trace.is_kernel(name))
    return n / rec["periods"] if n else None
