"""Surrogate training loop.

Port of the LSTM surrogate part of ``forging_control_tpu/nn/train.py``
(``_epoch_perm`` ``:83-87``, ``_surrogate_program`` ``:180-209``,
``train_surrogate`` ``:617-639``; the reference's ``Unsupervised
Learning/Model_NN/Main.py:224-239``): teacher-forced next-step MSE, AdamW,
per-epoch shuffled batches with the trailing ``n mod batch_size`` rows of
each epoch dropped, and a per-epoch validation loss.

The JAX package runs the whole run as one XLA program; here every epoch and
batch is a Python loop over eager ops, and the host syncs once per epoch.
The training step runs the module's autograd ``forward`` (the kernel has no
backward, in either package); the validation forward runs under no-grad
through ``infer``, so on a card it is one kernel launch per epoch.  The
JAX package's ``mesh`` sharding is not ported (one card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch


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
        table = (epoch_perm(gen, n, batch_size) if perms is None
                 else torch.as_tensor(np.array(perms[epoch])))
        losses = []
        for idx in table.to(device):
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
