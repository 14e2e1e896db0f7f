"""device_idle_pct.datagen: 100 minus the share of the traced stretch's
time in which the device ran an operation (the union of their intervals),
in percent."""

from benchmark.metrics_lib import device_idle_pct as read  # noqa: F401
