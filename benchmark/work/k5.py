"""The work of one AL-iLQR solve (kernel K5's job), counted from the
algorithm and the shapes alone.

The count follows the solve as ``benchmark/reference/ilqr.py`` states it,
whatever a kernel's body does: the initial rollout; per Gauss-Newton
iteration the linearisation of every stage by forward mode (7 tangent
directions: the augmented state z and the input v; 6 for the terminal
residual), the Gauss-Newton blocks, the backward Riccati sweep over the
6 x 6 blocks, the forward pass over every step size; per AL round the
multiplier update.  Every scenario runs every iteration (the fixed
iteration structure; a scenario that converged is masked, not skipped, in
the algorithm), so the count is what these shapes need.

The physics' operations are constants, counted on the frozen reference
physics (``benchmark/reference/physics.py`` ``count``, with every input a
dual): an add, multiply, divide, square root, logarithm,
exponential, power, absolute value, sign or extremum is one operation on
the value, and each tangent direction adds what its derivative rule costs
(a dual product 3, a quotient 3, a sum 1, ...); selects and comparisons
count nothing.  ``benchmark/tests/test_bench_harness.py``
(``test_physics_counts_are_the_reference_physics``) counts them again
from the reference and holds these numbers to it.

The bytes are the solve's inputs read once (x0, ref, u_prev, the warm
start v and lam) and its outputs written once (u0, v, lam and eight
diagnostics), in the configuration's dtype.
"""

from __future__ import annotations

# (on the values, per tangent direction), counted on the reference physics.
RHS = (124, 126)            # one evaluation of the press's dx/dt
RK4_COMBINE = (65, 65)      # one RK4 substep's update around its 4 evaluations
SCALE = (1, 1)              # v -> u = 0.01 v
# The residuals by the number of constraints a stage (2: p >= p_min; 4:
# and p <= p_max): a stage's input move, tracking and AL terms, and the
# terminal residual's tracking and AL terms.
STAGE_RES = {2: (13, 10), 4: (23, 20)}
TERM_RES = {2: (11, 8), 4: (21, 18)}

N_ALPHAS = 4                # the forward pass's step sizes
N_DIAG = 8                  # diagnostics written per solve
STATE = 6                   # augmented state z = [x (5), v_prev]


def _riccati_stage() -> int:
    """Operations of one backward-sweep stage over 6 x 6 blocks (n = 6):
    Qz, Qv, Qzz = Lzz + A' Vzz A, VB = Vzz B, Qvv, Qvz, the gains, the
    value function's update and the running max |Qv|."""
    n = STATE
    qz = 2 * n * n                     # A' Vz, plus lz
    qv = 2 * n                         # B . Vz, plus lv
    qzz = 2 * n ** 3 * 2 + n * n       # A' Vzz, then (.) A, plus Lzz
    vb = 2 * n * n
    qvv = 2 * n + 1                    # B . VB, plus Lvv, plus lm_reg
    qvz = 2 * n * n                    # VB . A, plus Lvz
    gains = 1 + n                      # kg = -Qv / Qvv, Kg = -Qvz / Qvv
    vz = 6 * n + 1
    vzz = 7 * n * n
    return qz + qv + qzz + vb + qvv + qvz + gains + vz + vzz + 2


def count(cfg: dict, batch: int, dtype_bytes: int = 4) -> dict:
    """Operations and bytes of ``batch`` solves of the configuration
    ``cfg`` (a ``benchmark/configs`` file): ``{"ops", "bytes"}``."""
    N = cfg["horizon"]
    nc = 2 if cfg.get("p_max") is None else 4
    nr = 2 + nc
    ss = cfg["substeps"]

    def pair(a, b, k=1):
        return (a[0] + k * b[0], a[1] + k * b[1])

    period = pair(SCALE, pair(
        (ss * RK4_COMBINE[0], ss * RK4_COMBINE[1]), RHS, 4 * ss))
    stage_res, term_res = STAGE_RES[nc], TERM_RES[nc]
    stage = pair(period, stage_res)
    lin = N * (stage[0] + (STATE + 1) * stage[1]) \
        + term_res[0] + STATE * term_res[1]
    # lz, lv, Lzz, Lvv, Lvz over the stage's residual rows; Vz, Vzz of the
    # terminal rows: a multiply and an add per term.
    blocks = N * 2 * nr * (STATE + 1 + STATE * STATE + 1 + STATE) \
        + 2 * (nr - 1) * (STATE + STATE * STATE)
    riccati = N * _riccati_stage()
    feedback = 2 + 3 * STATE            # v + a kg + Kg . (z - zs)
    forward = N_ALPHAS * (N * (period[0] + stage_res[0] + feedback + 2 * nr)
                          + term_res[0] + 2 * (nr - 1))
    accept = N_ALPHAS + 2               # argmin over the candidates, test
    gn = lin + blocks + riccati + forward + accept
    al_update = N * nc * 3              # lam - mu c, clamped at 0
    per_solve = N * period[0] + cfg["al_iters"] * (
        cfg["gn_iters"] * gn + al_update)
    words = (5 + 1 + 1 + N + N * nc) + (1 + N + N * nc + N_DIAG)
    return {"ops": batch * per_solve, "bytes": batch * words * dtype_bytes}
