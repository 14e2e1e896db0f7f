"""Forward-mode differentiation with a batch of tangents, for the solvers.

The JAX package takes every solver Jacobian as ``jax.linearize`` followed by
``vmap(jvp)`` over the basis directions (``solver/sqp.py`` ``res_and_jac``,
``solver/riccati.py`` ``stage_lin``).  Here the same forward mode is a small
dual-number type: a :class:`Dual` holds a primal tensor ``p`` of shape ``S``
and its tangents ``t`` of shape ``S + (D,)``, one trailing column per basis
direction.  The physics and solver code is written once against the helpers
below (``sqrt``, ``maximum``, ``where``, ...), which take plain tensors or
duals, so the plain rollout and its Jacobian share one source.

Why not ``torch.func.jvp``/``jacfwd``: with PyTorch's forward AD every binary
op whose other operand carries no tangent (every physics constant) goes
through the zero-tensor fallback, and ``vmap`` over the directions adds its
own batching rules on top, so ``vmap(jacfwd)`` of ``press.rhs`` spends far
more host time than the same Jacobian through these duals.  A closed-loop
step is some 10^5 such ops, and eager dispatch is what bounds it on any
device.  Here each dual op is one primal op and one to three tangent ops on
ordinary tensors, and the D directions ride along as a batch axis.

The tangent rules follow JAX's ``jvp`` rules, including their values at ties
(``maximum``/``minimum`` give each side one half; ``abs`` gives +1 at 0; a
clip is ``minimum(maximum(x, lo), hi)``), so Jacobians agree with the JAX
package's to rounding.  On plain tensors that require a gradient the helpers
keep JAX's rules for reverse mode too (``torch.clamp_min`` passes the whole
gradient at a tie and ``torch.abs`` passes 0 at 0); on tensors that do not,
they take the cheapest torch op with the same values.
"""

from __future__ import annotations

import torch


def _e(a):
    """Primal value broadcast against a tangent (trailing direction axis)."""
    return a.unsqueeze(-1) if isinstance(a, torch.Tensor) else a


def _key(key):
    """Index a tangent like its primal: keep the trailing direction axis."""
    if not isinstance(key, tuple):
        key = (key,)
    if any(k is Ellipsis for k in key):
        return key + (slice(None),)
    return key


class Dual:
    """Primal ``p`` (shape S) with tangents ``t`` (shape S + (D,))."""

    __slots__ = ("p", "t")

    def __init__(self, p, t):
        self.p = p
        self.t = t

    @property
    def shape(self):
        return self.p.shape

    def _fit(self, shape):
        """Tangent expanded to the broadcast primal shape."""
        t = self.t
        if t.shape[:-1] != shape:
            t = t.expand(*shape, t.shape[-1])
        return t

    def __getitem__(self, key):
        return Dual(self.p[key], self.t[_key(key)])

    def __neg__(self):
        return Dual(-self.p, -self.t)

    def __add__(self, o):
        if isinstance(o, Dual):
            return Dual(self.p + o.p, self.t + o.t)
        p = self.p + o
        return Dual(p, self._fit(p.shape))

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Dual):
            return Dual(self.p - o.p, self.t - o.t)
        p = self.p - o
        return Dual(p, self._fit(p.shape))

    def __rsub__(self, o):
        p = o - self.p
        return Dual(p, -self._fit(p.shape))

    def __mul__(self, o):
        if isinstance(o, Dual):
            return Dual(self.p * o.p, self.t * _e(o.p) + _e(self.p) * o.t)
        return Dual(self.p * o, self.t * _e(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Dual):
            return Dual(self.p / o.p,
                        self.t / _e(o.p) + (-o.t * _e(self.p)) * _e(o.p ** -2))
        return Dual(self.p / o, self.t / _e(o))

    def __rtruediv__(self, o):
        return Dual(o / self.p, (-self.t * _e(o)) * _e(self.p ** -2))

    def __pow__(self, c: float):
        return Dual(self.p ** c, self.t * _e(c * self.p ** (c - 1.0)))

    def __gt__(self, o):
        return self.p > _primal(o)

    def __ge__(self, o):
        return self.p >= _primal(o)

    def __lt__(self, o):
        return self.p < _primal(o)

    def __le__(self, o):
        return self.p <= _primal(o)


def _primal(a):
    return a.p if isinstance(a, Dual) else a


def _tangent(a, shape, n_dir, like):
    """Tangent of ``a`` at ``shape`` (zeros for a constant)."""
    if isinstance(a, Dual):
        return a._fit(shape)
    return torch.zeros((), dtype=like.dtype, device=like.device).expand(
        *shape, n_dir)


def _n_dir(*args):
    for a in args:
        if isinstance(a, Dual):
            return a.t.shape[-1]
    return None


def sqrt(a):
    if isinstance(a, Dual):
        s = torch.sqrt(a.p)
        return Dual(s, a.t * _e(0.5 / s))
    return torch.sqrt(a)


def exp(a):
    if isinstance(a, Dual):
        ex = torch.exp(a.p)
        return Dual(ex, a.t * _e(ex))
    return torch.exp(a)


def log(a):
    if isinstance(a, Dual):
        return Dual(torch.log(a.p), a.t / _e(a.p))
    return torch.log(a)


def sign(a):
    if isinstance(a, Dual):
        return torch.sign(a.p)          # zero tangent: a constant
    return torch.sign(a)


def _grad(a) -> bool:
    return isinstance(a, torch.Tensor) and a.requires_grad


def abs(a):  # noqa: A001 - mirrors jnp.abs
    if isinstance(a, Dual):
        return Dual(torch.abs(a.p), torch.where(_e(a.p >= 0), a.t, -a.t))
    if _grad(a):
        # JAX's derivative: +1 at 0 (torch.abs gives 0); "+ 0.0" turns the
        # -0.0 that -(-0.0) would leave into torch.abs's +0.0.
        return torch.where(a >= 0, a, -a) + 0.0
    return torch.abs(a)


def _as_tensor(b, like):
    """``b``, or the Python number ``b`` as a 0-d tensor of ``like``'s dtype
    and device, made by a fill op: never a copy from host memory, which
    would wait on the stream and cannot be captured in a CUDA graph."""
    return b if isinstance(b, torch.Tensor) else torch.full(
        (), b, dtype=like.dtype, device=like.device)


def constants(values, dtype, device) -> torch.Tensor:
    """A 1-D tensor of the Python numbers ``values``, made by one fill op
    each on ``device`` (with ``torch.tensor``'s values: each number rounded
    to ``dtype``), so that a control period holds no copy from host
    memory."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


def _extremum(a, b, op):
    pa, pb = _primal(a), _primal(b)
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        if _grad(pa) or _grad(pb):
            # torch.maximum/minimum of two tensors split the gradient one
            # half each at a tie, as JAX does; clamp_min/max would not.
            like = pa if isinstance(pa, torch.Tensor) else pb
            return op(_as_tensor(pa, like), _as_tensor(pb, like))
        if not isinstance(pb, torch.Tensor):
            return (torch.clamp_min if op is torch.maximum
                    else torch.clamp_max)(pa, pb)
        if not isinstance(pa, torch.Tensor):
            return (torch.clamp_min if op is torch.maximum
                    else torch.clamp_max)(pb, pa)
        return op(pa, pb)
    like = pa if isinstance(pa, torch.Tensor) else pb
    pa, pb = _as_tensor(pa, like), _as_tensor(pb, like)
    ans = op(pa, pb)
    # JAX's _balanced_eq: 1 where this side is the extremum, 1/2 at a tie.
    one = torch.ones((), dtype=ans.dtype, device=ans.device)
    two = one + one
    zero = torch.zeros((), dtype=ans.dtype, device=ans.device)

    def weight(x, y):
        return (torch.where(x == ans, one, zero)
                / torch.where(y == ans, two, one))

    n = _n_dir(a, b)
    t = 0.0
    if isinstance(a, Dual):
        t = a._fit(ans.shape) * _e(weight(pa, pb))
    if isinstance(b, Dual):
        t = t + b._fit(ans.shape) * _e(weight(pb, pa))
    if not isinstance(t, torch.Tensor):
        t = _tangent(None, ans.shape, n, ans)
    return Dual(ans, t)


def maximum(a, b):
    """``jnp.maximum`` with JAX's tangent (one half to each side at a tie)."""
    return _extremum(a, b, torch.maximum)


def minimum(a, b):
    return _extremum(a, b, torch.minimum)


def clip(a, lo, hi):
    """``jnp.clip``: ``minimum(maximum(a, lo), hi)``.  ``torch.clamp``
    has the same values but passes the whole gradient at the bounds, so it
    serves only where no derivative is taken."""
    if (not any(isinstance(v, Dual) or _grad(v) for v in (a, lo, hi))
            and isinstance(lo, torch.Tensor) == isinstance(hi, torch.Tensor)):
        return torch.clamp(a, lo, hi)
    if lo is not None:
        a = maximum(a, lo)
    return a if hi is None else minimum(a, hi)


def where(cond, a, b):
    """``jnp.where``; a Python number on one side goes to ``torch.where``
    as a scalar (one side must be a tensor or a dual)."""
    if not isinstance(a, Dual) and not isinstance(b, Dual):
        return torch.where(cond, a, b)
    pa, pb = _primal(a), _primal(b)
    p = torch.where(cond, pa, pb)
    n = _n_dir(a, b)
    t = torch.where(_e(cond), _tangent(a, p.shape, n, p),
                    _tangent(b, p.shape, n, p))
    return Dual(p, t)


def _join(fn, xs, dim):
    if not any(isinstance(x, Dual) for x in xs):
        return fn(xs, dim)
    n = _n_dir(*xs)
    ps = [_primal(x) for x in xs]
    ts = [_tangent(x, p.shape, n, ps[0]) for x, p in zip(xs, ps)]
    return Dual(fn(ps, dim), fn(ts, dim - 1 if dim < 0 else dim))


def stack(xs, dim=-1):
    return _join(torch.stack, list(xs), dim)


def cat(xs, dim=-1):
    return _join(torch.cat, list(xs), dim)


def primal(a):
    """The primal tensor of a dual (or the tensor itself)."""
    return _primal(a)


def linearize(fn, x):
    """Value and Jacobian of ``fn`` at ``x`` (last axis = inputs).

    ``fn`` maps (..., n) to (..., m) elementwise over the leading axes.
    Returns ``(fn(x), J)`` with ``J[..., o, i] = d fn(x)_o / d x_i`` — the
    counterpart of ``jax.linearize`` then ``vmap(jvp)`` over ``eye(n)``.
    """
    n = x.shape[-1]
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    out = fn(Dual(x, eye.expand(*x.shape, n)))
    if not isinstance(out, Dual):      # fn does not depend on x
        return out, torch.zeros(*out.shape, n, dtype=x.dtype,
                                device=x.device)
    return out.p, out._fit(out.p.shape)
