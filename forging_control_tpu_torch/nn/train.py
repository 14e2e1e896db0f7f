"""Training loops: the LSTM surrogate and the supervised FNN imitation.

Port of the surrogate and supervised parts of
``forging_control_tpu/nn/train.py`` (``_epoch_perm`` ``:83-87``,
``_supervised_program`` ``:95-124``, ``_surrogate_program`` ``:180-209``,
``make_closed_loop_val`` ``:212-253``, ``train_supervised`` ``:256-280``,
``train_surrogate`` ``:617-639``): AdamW, per-epoch shuffled batches with
the trailing ``n mod batch_size`` rows of each epoch dropped, and a
per-epoch validation loss.  The surrogate trains on the teacher-forced
next-step MSE (the reference's ``Unsupervised Learning/Model_NN/
Main.py:224-239``), the FNN controller on the L1 imitation loss of the
recorded MPC commands (``Supervised Learning/Main.py:272-286``).

The JAX package runs each training run as one XLA program; here every
epoch and batch is a Python loop over eager ops, and the host syncs once
per epoch.  The surrogate's training step runs the module's autograd
``forward`` (the kernel has no backward, in either package); its validation
forward runs under no-grad through ``infer``, so on a card it is one kernel
launch per epoch.  The JAX package's ``mesh`` sharding of the batches is
not ported (one card; ROADMAP Queue A 13).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import fnn


@dataclass
class TrainReport:
    train_losses: list = field(default_factory=list)
    val_losses: list = field(default_factory=list)
    cl_val_losses: list = field(default_factory=list)  # closed-loop val MAE
    wall_time_s: float = 0.0
    selected_seed: int | None = None  # set by multi-seed pipeline selection


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def epoch_perm(generator: torch.Generator, n: int,
               batch_size: int) -> torch.Tensor:
    """(n_batches, batch_size) shuffled index table of one epoch, drawn on
    the generator's device; the trailing n mod batch_size rows are dropped.
    Not the JAX package's ``jax.random.permutation``: parity runs pass the
    JAX tables in (``perms``)."""
    bs = min(batch_size, n)
    nb = n // bs
    perm = torch.randperm(n, generator=generator, device=generator.device)
    return perm[:nb * bs].reshape(nb, bs)


def _tables(perms, epoch, gen, n, batch_size, device):
    table = (epoch_perm(gen, n, batch_size) if perms is None
             else torch.as_tensor(np.array(perms[epoch])))
    return table.to(device)


def train_supervised(params, x_train, y_train, x_val, y_val, *,
                     width_dim=1, lr=1e-3, weight_decay=1e-2, epochs=20,
                     batch_size=256, loss_fn=l1_loss, seed=0, perms=None,
                     log_fn: Callable | None = None):
    """Supervised imitation trainer: the FNN mimics recorded MPC commands.

    ``params`` (a dict of tensors, ``nn/fnn.py``) is copied and the copy
    trained on its own device; the data (arrays or tensors) are moved there
    and promoted with the weights' dtype, as JAX promotes them.  Returns
    (trained params, :class:`TrainReport`).  ``perms`` and the batch tables
    drawn without it are as in :func:`train_surrogate`; ``torch.optim.AdamW``
    with its defaults is the arithmetic of ``optax.adamw``."""
    device = params["w_in"].device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}

    def data(a):
        a = torch.as_tensor(a, device=device)
        return a.to(torch.promote_types(a.dtype, p["w_in"].dtype))

    xt, yt, xv, yv = map(data, (x_train, y_train, x_val, y_val))
    opt = torch.optim.AdamW(list(p.values()), lr=lr,
                            weight_decay=weight_decay)
    # Zero gradients rather than none: optax decays every leaf, also those
    # the forward does not use (w_int, b_int at width_dim = 1), and AdamW
    # skips a parameter whose gradient is None.
    for v in p.values():
        v.grad = torch.zeros_like(v)
    gen = torch.Generator().manual_seed(seed)

    report = TrainReport()
    t0 = time.time()
    for epoch in range(epochs):
        losses = []
        for idx in _tables(perms, epoch, gen, len(xt), batch_size, device):
            loss = loss_fn(fnn.apply(p, xt[idx], width_dim), yt[idx])
            opt.zero_grad(set_to_none=False)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            val = loss_fn(fnn.apply(p, xv, width_dim), yv)
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(float(val))
        if log_fn:
            log_fn(epoch, report.train_losses[-1], report.val_losses[-1])
    report.wall_time_s = time.time() - t0
    return {k: v.detach() for k, v in p.items()}, report


def make_closed_loop_val(in_scaler, u_scaler, *, n_traj: int = 8,
                         t_traj: int = 300, dtype=torch.float32,
                         seed: int = 0, variant: str = "smooth",
                         ref_variant: str = "unsupervised",
                         width_dim: int = 1,
                         process_std: tuple = (0.0,) * 5, refs=None,
                         device="cuda"):
    """True-plant validation rollout: ``val(params) -> tracking MAE``.

    Rolls a candidate FNN controller in closed loop against the RK4 plant
    on validation reference streams distinct from the CPython-exact
    evaluation streams (model selection never sees the test references);
    used for multi-seed selection.  ``refs`` (n_traj, t_traj) replaces the
    streams drawn from a ``torch.Generator`` seeded with ``seed + 9000``
    (non-parity, like the JAX package's ``jax.random`` draws), so a parity
    run passes the JAX package's.  ``process_std`` injects plant process
    noise, drawn from a generator seeded with ``seed + 9001`` anew at each
    call, so every candidate sees the same noise."""
    from ..device import resolve_device
    from ..eval import metrics
    from ..loop import closed_loop as cl
    from ..physics import press
    from ..refgen import streams

    device = resolve_device(device)
    loop_cfg = cl.LoopConfig(t_steps=t_traj, variant=variant,
                             process_std=tuple(process_std))
    if refs is None:
        refs = streams.sample_references(
            torch.Generator().manual_seed(seed + 9000), n_traj, ref_variant,
            t_traj, dtype=dtype, device=device)
    if not isinstance(refs, torch.Tensor):
        refs = torch.from_numpy(np.array(refs))
    refs = refs.to(device, dtype)
    x0 = torch.tensor(press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(refs.shape[0], 1)

    @torch.no_grad()
    def val(params):
        ctrl = cl.FunctionController(
            fnn.make_policy(params, in_scaler, u_scaler, width_dim))
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs,
                                torch.Generator().manual_seed(seed + 9001),
                                device=device)
        return metrics.mae(telem.ref, telem.x[..., 1])

    return val


def train_surrogate(model, x_train, y_train, x_val, y_val, *, lr=1e-3,
                    weight_decay=1e-2, epochs=50, batch_size=256, seed=0,
                    perms=None, log_fn: Callable | None = None):
    """LSTM surrogate trainer: teacher-forced next-step MSE.

    ``model`` (an ``LSTMSurrogate``) is trained in place on its own device
    and returned with a :class:`TrainReport`.  The data are tensors on that
    device.  ``perms``, if given, holds one (n_batches, batch_size) index
    table per epoch (e.g. the JAX package's); otherwise they are drawn from
    a CPU ``torch.Generator`` seeded with ``seed``.  ``log_fn(epoch,
    train_loss, val_loss)`` is called after each epoch.

    ``torch.optim.AdamW(lr, weight_decay)`` with its defaults (beta =
    0.9/0.999, eps = 1e-8, decay on every parameter) is the arithmetic of
    ``optax.adamw``.
    """
    device = x_train.device
    opt = torch.optim.AdamW(model.parameters(), lr=lr,
                            weight_decay=weight_decay)
    gen = torch.Generator().manual_seed(seed)
    n = x_train.shape[0]

    report = TrainReport()
    t0 = time.time()
    for epoch in range(epochs):
        losses = []
        for idx in _tables(perms, epoch, gen, n, batch_size, device):
            loss = mse_loss(model(x_train[idx]), y_train[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        val = mse_loss(model.infer(x_val), y_val)
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(float(val))
        if log_fn:
            log_fn(epoch, report.train_losses[-1], report.val_losses[-1])
    report.wall_time_s = time.time() - t0
    return model, report
