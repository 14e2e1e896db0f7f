"""Plain reference of the press physics, its RK4 step and forward-mode
derivatives: the benchmark's own frozen copy, in plain PyTorch.

It follows the published model (``Generate Data/template_model.py`` of the
reference project: the 5-state press x = [y, y_dot, p1, p2, z], input u the
servo-valve tension) in the form the controller deployment runs it: the
"smooth" pressure floor, the gated forging force evaluated at clipped
arguments, the orifice flow blended linearly below ``EPS_Q``, friction with
its deadband.  It imports nothing of the program under test.

A state is a tuple of its five components, each a tensor of the batch
shape or a :class:`Dual` (a primal with a leading axis of tangents), so
one source gives the plant, its Jacobians and, in a lower dtype, the
precision control.  On duals every operation is seen by :func:`count`,
from which ``benchmark/work`` derives the physics' operation count.
"""

from __future__ import annotations

import math

import torch

# Constants of the press (template_model.py:20-92), SI units.
M, B_VISC, FT, D1, D2, G = 90000.0, 25000.0, 200000.0, 0.6, 0.5, 9.81
KB, V1_0, V2_0, KL_1, KL_2 = 22e9, 0.3, 0.1, 8e-13, 14e-14
CD, RHO, D_HOLE, PS, PT, T1 = 0.63, 858.0, 0.006, 32e6, 101325.0, 0.005
MU_F, K_F, W0, H0, B0, TEMP = 0.3, 1.115, 0.2, 0.5, 0.1, 900.0
M0, M1, M2, M3, M4 = 1200e6, -0.0025, -0.0587, 0.1165, -0.0065
EPS_Y, EPS_Q, EPS_SMOOTH = 1e-6, 1e-2, 1e-6
A1 = math.pi * D1 ** 2 / 4.0
A2 = math.pi * D2 ** 2 / 4.0
A_SPREAD = 0.14 + 0.36 * (B0 / W0) - 0.054 * (B0 / W0) ** 2
U_SCALE = 0.01      # the NLP's input scaling
P_SCALE = 1e7       # the NLP's pressure scaling
X_SCALE = (0.1, 0.1, 1e7, 1e7, 0.01)

X0 = (0.0, 0.0, 2156275.6006012624, 2961363.827545376, 0.0)


_COUNT = None     # [values, per direction] while count() runs


def count(fn) -> tuple[int, int]:
    """The arithmetic operations that ``fn()`` performs through this
    module on its values and on each tangent direction: an add, multiply,
    divide, square root, logarithm, exponential, power, absolute value,
    sign or extremum counts one on the value, a tangent direction what its
    derivative rule costs; a select or a comparison counts nothing, nor
    does an operation between constants (Python folds them).  Only
    operations on duals and this module's functions are seen, so give
    ``fn`` duals to count everything."""
    global _COUNT
    _COUNT = [0, 0]
    try:
        fn()
        return tuple(_COUNT)
    finally:
        _COUNT = None


def _op(n=1, nt=0):
    if _COUNT is not None:
        _COUNT[0] += n
        _COUNT[1] += nt


class Dual:
    """Primal ``p`` with tangents ``t``: one per direction along a leading
    axis, ``t[d]`` of ``p``'s shape (or broadcasting to it)."""

    __slots__ = ("p", "t")

    def __init__(self, p, t):
        self.p, self.t = p, t

    def _t(self, shape):
        t = self.t
        return t if t.shape[1:] == shape else t.expand(t.shape[0], *shape)

    def __add__(self, o):
        if isinstance(o, Dual):
            _op(1, 1)
            return Dual(self.p + o.p, self.t + o.t)
        _op()
        p = self.p + o
        return Dual(p, self._t(p.shape))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            _op(1, 1)
            return Dual(self.p - o.p, self.t - o.t)
        _op()
        p = self.p - o
        return Dual(p, self._t(p.shape))

    def __rsub__(self, o):
        _op(1, 1)
        p = o - self.p
        return Dual(p, -self._t(p.shape))

    def __neg__(self):
        _op(1, 1)
        return Dual(-self.p, -self.t)

    def __mul__(self, o):
        if isinstance(o, Dual):
            _op(1, 3)
            return Dual(self.p * o.p, self.t * o.p + self.p * o.t)
        _op(1, 1)
        return Dual(self.p * o, self.t * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Dual):
            _op(1, 3)
            q = self.p / o.p
            return Dual(q, (self.t - q * o.t) / o.p)
        _op(1, 1)
        return Dual(self.p / o, self.t / o)

    def __rtruediv__(self, o):
        _op(2, 1)
        q = o / self.p
        return Dual(q, -self.t * (q / self.p))

    def __pow__(self, c):
        _op(3, 1)
        return Dual(self.p ** c, self.t * (c * self.p ** (c - 1.0)))

    def __gt__(self, o):
        return self.p > primal(o)

    def __ge__(self, o):
        return self.p >= primal(o)

    def __lt__(self, o):
        return self.p < primal(o)

    def __le__(self, o):
        return self.p <= primal(o)


def primal(a):
    return a.p if isinstance(a, Dual) else a


def _plain(a):
    """Count an operation on a plain tensor and return its value."""
    _op()
    return a


# Each of these takes tensors or duals and counts one operation.

def sqrt(a):
    if isinstance(a, Dual):
        _op(2, 1)
        s = torch.sqrt(a.p)
        return Dual(s, a.t * (0.5 / s))
    return _plain(torch.sqrt(a))


def log(a):
    if isinstance(a, Dual):
        _op(1, 1)
        return Dual(torch.log(a.p), a.t / a.p)
    return _plain(torch.log(a))


def exp(a):
    if isinstance(a, Dual):
        _op(1, 1)
        e = torch.exp(a.p)
        return Dual(e, a.t * e)
    return _plain(torch.exp(a))


def fabs(a):
    """|a|, whose derivative is +1 at 0."""
    if isinstance(a, Dual):
        _op(1, 1)
        return Dual(torch.abs(a.p), torch.where(a.p >= 0, a.t, -a.t))
    return _plain(torch.abs(a))


def sign(a):
    """sign(a), whose derivative is 0."""
    return _plain(torch.sign(primal(a)))


def maximum(a, c: float):
    """max(a, c) for a number c; at a tie the tangent is halved."""
    if isinstance(a, Dual):
        _op(1, 1)
        p = torch.clamp_min(a.p, c)
        w = torch.where(a.p > c, 1.0, torch.where(a.p == c, 0.5, 0.0))
        return Dual(p, a.t * w.to(p.dtype))
    return _plain(torch.clamp_min(a, c))


def minimum(a, c: float):
    """min(a, c) for a number c; at a tie the tangent is halved."""
    if isinstance(a, Dual):
        _op(1, 1)
        p = torch.clamp_max(a.p, c)
        w = torch.where(a.p < c, 1.0, torch.where(a.p == c, 0.5, 0.0))
        return Dual(p, a.t * w.to(p.dtype))
    return _plain(torch.clamp_max(a, c))


def where(cond, a, b):
    """Select ``a`` where ``cond`` holds, else ``b`` (one is a tensor or a
    dual; a number on the other side is a constant)."""
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return torch.where(cond, a, b)
    p = torch.where(cond, primal(a), primal(b))
    n = _n_dir(a, b)
    return Dual(p, torch.where(cond, _tan(a, p.shape, n, p.dtype),
                               _tan(b, p.shape, n, p.dtype)))


def _n_dir(*xs):
    return next(x.t.shape[0] for x in xs if isinstance(x, Dual))


def _tan(x, shape, n, dtype):
    """The tangents of ``x`` at ``shape`` (zeros for a constant)."""
    if isinstance(x, Dual):
        return x._t(shape)
    return torch.zeros((), dtype=dtype).expand(n, *shape)


def stack(xs, dim=-1):
    """Stack tensors or duals along a new axis ``dim`` (< 0)."""
    if not any(isinstance(x, Dual) for x in xs):
        return torch.stack(xs, dim)
    shape = torch.broadcast_shapes(*(primal(x).shape for x in xs))
    n = _n_dir(*xs)
    p = torch.stack([primal(x).expand(shape) for x in xs], dim)
    return Dual(p, torch.stack([_tan(x, shape, n, p.dtype) for x in xs], dim))


def seed(x):
    """The components of ``x`` (..., n) as duals whose tangents are the
    identity: direction d is the derivative with respect to x[..., d]."""
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype).reshape(n, *([1] * (x.dim() - 1)), n)
    t = eye.expand(n, *x.shape)
    return tuple(Dual(x[..., i], t[..., i]) for i in range(n))


def jacobian(out):
    """A stacked dual (..., m) as (values (..., m), J (..., m, n)), J[..., o,
    d] the derivative of output o along direction d."""
    return out.p, out.t.movedim(0, -1)


# The physics -----------------------------------------------------------------

def smooth_floor(p):
    """C1 floor at 0: 0.5 (p + sqrt(p^2 + eps)) (template_model.py:107)."""
    return 0.5 * (p + sqrt(p * p + EPS_SMOOTH))


def forging_force(y, y_dot):
    """The forging force (template_model.py:74-99), zero unless y > 0 and
    y_dot >= 0; the gated branch is taken at clipped arguments."""
    gate = (primal(y) > 0.0) & (primal(y_dot) >= 0.0)
    y_s = minimum(maximum(y, EPS_Y), H0 * (1.0 - 1e-9))
    yd_s = maximum(y_dot, 0.0)
    h1 = H0 - y_s
    w1 = W0 * (H0 / h1) ** A_SPREAD
    b1 = B0 * (1.0 + 0.67 * (H0 / h1 * W0 / w1 - 1.0))
    kd = K_F * (1.0 + MU_F * b1 / (2.0 * y_s) + y_s / (4.0 * b1))
    e = maximum(log(H0 / (H0 - y_s)), 1e-12)
    e_dot = maximum(yd_s / (H0 - y_s), 1e-30)
    fd = (kd * (w1 * b1) * M0 * math.exp(M1 * TEMP) * e ** M2
          * e_dot ** M3 * exp(M4 / e))
    return where(gate, fd, 0.0)


def _orifice(dp):
    """sqrt(2/rho |dp|) sign(dp), linear below EPS_Q."""
    m = fabs(dp)
    s = 2.0 / RHO
    kink = primal(m) <= EPS_Q
    lin = s * m / math.sqrt(s * EPS_Q)
    root = sqrt(s * where(kink, 1.0, m))
    return where(kink, lin, root) * sign(dp)


def rhs(x, u):
    """dx/dt of the press for components ``x`` (5-tuple) and input u."""
    y, y_dot, p1, p2, z = x
    p1e, p2e = smooth_floor(p1), smooth_floor(p2)
    fd = forging_force(y, y_dot)
    ft = where(fabs(primal(y_dot)) <= 0.5, FT * y_dot / 0.5, FT)
    c = math.pi * D_HOLE * CD
    work = primal(z) >= 0.0
    q_pb = c * z * _orifice(where(work, PS - p1e, p1e - PT))
    q_at = c * z * _orifice(where(work, p2e - PT, PS - p2e))
    v1 = V1_0 / 2.0 + A1 * y
    v2 = V2_0 / 2.0 - A2 * y
    dy_dot = (3.0 * math.pi * D1 ** 2 * p1e / 4.0
              - math.pi * D2 ** 2 * p2e / 2.0 - B_VISC * y_dot - ft - fd) \
        / M + G
    dp1 = KB / v1 * (q_pb / 3.0 - A1 * y_dot - KL_1 * p1e)
    dp2 = KB / v2 * (-q_at / 2.0 + A2 * y_dot - KL_2 * p2e)
    dz = (-z + u) / T1
    return (y_dot, dy_dot, dp1, dp2, dz)


def measure(x):
    """The smooth variant's measurement: the floored pressures."""
    y, y_dot, p1, p2, z = x
    return (y, y_dot, smooth_floor(p1), smooth_floor(p2), z)


def rk4(x, u, dt, substeps, w=None):
    """One period of RK4 (``substeps`` steps) of dx/dt = rhs(x, u) + w,
    u held and w constant over the period; x and w are 5-tuples."""
    h = dt / substeps

    def f(xx):
        d = rhs(xx, u)
        return d if w is None else tuple(a + b for a, b in zip(d, w))

    for _ in range(substeps):
        k1 = f(x)
        k2 = f(tuple(a + 0.5 * h * k for a, k in zip(x, k1)))
        k3 = f(tuple(a + 0.5 * h * k for a, k in zip(x, k2)))
        k4 = f(tuple(a + h * k for a, k in zip(x, k3)))
        x = tuple(a + (h / 6.0) * (q1 + 2.0 * q2 + 2.0 * q3 + q4)
                  for a, q1, q2, q3, q4 in zip(x, k1, k2, k3, k4))
    return x
