from .rk4 import make_stepper, rk4_step  # noqa: F401
