"""Scenario parallelism over ``torch.distributed`` ranks."""

from . import launcher, mesh  # noqa: F401
