"""Utilities: checkpoints (the JAX package's npz format and dcp
directories), do-mpc pickles, logging, timing, progress, notifications and
profiling."""

from . import checkpoint, notify, profiling, progress, timer  # noqa: F401
