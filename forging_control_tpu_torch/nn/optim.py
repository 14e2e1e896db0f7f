"""The optimizer arithmetic of the trainers, as tensor code.

The counterpart of the optax pieces that the JAX package's trainers use
(``optax.adamw``, ``cosine_decay_schedule``, ``clip_by_global_norm``,
``apply_if_finite`` and ``chain``): a :class:`Transform` is an ``init``
(parameters -> state) and an ``update`` ((gradients, state, parameters) ->
(updates, state)), and :func:`apply_updates` adds the updates, as in optax.
Parameters, gradients and updates are lists of tensors; a state is a tree
of tensors (NamedTuples and tuples), which ``loop.graph`` copies into the
static buffers of a captured training step.

Everything a step changes lives in device tensors: the update count, the
learning rate a schedule gives for it, the moments and ``apply_if_finite``'s
counters.  An update makes no tensor from host data, reads no value back
and takes no Python branch on one, so the same ops run eagerly on the CPU
and inside a CUDA graph on a card.  (``torch.optim.AdamW`` holds its step
count and ``LambdaLR``'s rate as host numbers, which a graph would bake in;
its capturable form runs on no CPU.)

The arithmetic is optax's, op for op: ``mu = (1 - b1) g + b1 mu``, ``nu =
(1 - b2) g^2 + b2 nu``, the bias corrections ``1 - b^(count + 1)`` in
float64 and cast to the moment's dtype, ``u = mu_hat / (sqrt(nu_hat) +
eps) + weight_decay p``, scaled by ``-lr(count)`` in the parameter's dtype.
The count is a float64 0-d tensor (optax's is int32; every count below 2^53
is exact in both).
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch


class Transform(NamedTuple):
    """``optax.GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


class AdamWState(NamedTuple):
    count: torch.Tensor   # () float64: updates applied so far
    mu: tuple
    nu: tuple


class FiniteState(NamedTuple):
    """``optax.ApplyIfFiniteState``."""

    notfinite_count: torch.Tensor   # () int32: non-finite updates in a row
    last_finite: torch.Tensor       # () bool
    total_notfinite: torch.Tensor   # () int32
    inner_state: tuple


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    """``optax.cosine_decay_schedule``: update count -> learning rate,
    ``init_value * ((1 - alpha) * (1 + cos(pi * min(t, T) / T)) / 2 +
    alpha)``, in float64.  The count is a tensor (a number is made one)."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count):
        count = torch.clamp(torch.as_tensor(count, dtype=torch.float64),
                            max=float(decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def adamw(learning_rate, weight_decay: float = 1e-4, b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8) -> Transform:
    """``optax.adamw``: ``learning_rate`` is a number or a schedule (count
    tensor -> rate tensor), which reads the count before the update, as
    optax's ``scale_by_schedule`` does."""

    def init(params):
        return AdamWState(
            count=torch.zeros((), dtype=torch.float64,
                              device=params[0].device),
            mu=tuple(torch.zeros_like(p) for p in params),
            nu=tuple(torch.zeros_like(p) for p in params))

    def update(grads, state, params):
        mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
        nu = tuple((1 - b2) * torch.square(g) + b2 * v
                   for g, v in zip(grads, state.nu))
        count = state.count + 1
        c1, c2 = 1 - torch.pow(b1, count), 1 - torch.pow(b2, count)
        step = (-learning_rate(state.count) if callable(learning_rate)
                else -learning_rate)
        updates = []
        for m, v, p in zip(mu, nu, params):
            u = (m / c1.to(m.dtype)) / (torch.sqrt(v / c2.to(v.dtype)) + eps)
            u = u + weight_decay * p
            updates.append((step.to(u.dtype) if callable(learning_rate)
                            else step) * u)
        return updates, AdamWState(count, mu, nu)

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """``optax.clip_by_global_norm``: every leaf scaled by max_norm / norm
    unless the global norm (``optax.global_norm``) is below max_norm.  The
    norm sums the leaves' squares in the order given: pass them in the JAX
    package's leaf order."""

    def update(grads, state, params=None):
        g_norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        trigger = g_norm < max_norm
        return [torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
                for g in grads], state

    return Transform(lambda params: (), update)


def chain(*transforms: Transform) -> Transform:
    """``optax.chain``: the transforms in turn, their states a tuple."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params):
        out = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            out.append(s)
        return grads, tuple(out)

    return Transform(init, update)


def _select(keep, new, old):
    """``torch.where(keep, new, old)`` over two trees of tensors (tuples
    and NamedTuples)."""
    if isinstance(new, torch.Tensor):
        return torch.where(keep, new, old)
    leaves = [_select(keep, a, b) for a, b in zip(new, old)]
    return type(new)(*leaves) if hasattr(new, "_fields") else tuple(leaves)


def apply_if_finite(inner: Transform,
                    max_consecutive_errors: int) -> Transform:
    """``optax.apply_if_finite``: an update whose gradients are not all
    finite is dropped (zero updates, the inner state kept), unless it is
    the ``max_consecutive_errors + 1``-th such in a row.  The inner update
    is computed either way and selected on the device."""

    def init(params):
        zero = torch.zeros((), dtype=torch.int32, device=params[0].device)
        return FiniteState(zero, torch.ones((), dtype=torch.bool,
                                            device=zero.device),
                           zero.clone(), inner.init(params))

    def update(grads, state, params):
        isfinite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        notfinite = torch.where(isfinite, 0, state.notfinite_count + 1)
        apply = isfinite | (notfinite > max_consecutive_errors)
        updates, inner_state = inner.update(grads, state.inner_state, params)
        updates = [torch.where(apply, u, 0.0) for u in updates]
        return updates, FiniteState(
            notfinite, isfinite,
            torch.where(isfinite, state.total_notfinite,
                        state.total_notfinite + 1),
            _select(apply, inner_state, state.inner_state))

    return Transform(init, update)


def apply_updates(params, updates) -> list:
    """``optax.apply_updates``: ``p + u`` for every leaf."""
    return [p + u for p, u in zip(params, updates)]
