from . import lstm, probe, smallchol  # noqa: F401
from .smallchol import chol_solve, chol_solve_cuda, chol_solve_torch  # noqa: F401
