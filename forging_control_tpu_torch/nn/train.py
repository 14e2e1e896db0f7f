"""Training loops: the LSTM surrogate, the supervised FNN imitation, the
MPC-loss (unsupervised) trainer, plant-in-loop BPTT and DAgger.

Port of ``forging_control_tpu/nn/train.py`` (``_epoch_perm`` ``:83-87``,
``_supervised_program`` ``:95-124``, ``_unsupervised_program``
``:127-177``, ``_surrogate_program`` ``:180-209``, ``make_closed_loop_val``
``:212-253``, ``train_supervised`` ``:256-280``, ``train_unsupervised``
``:283-350``, ``train_plant_in_loop`` ``:353-475``, ``dagger_rollout``
``:478-544``, ``train_dagger`` ``:547-614``, ``train_surrogate``
``:617-639``): AdamW, per-epoch shuffled batches with the trailing
``n mod batch_size`` rows of each epoch dropped, and a per-epoch validation
loss.  The surrogate trains on the teacher-forced next-step MSE (the
reference's ``Unsupervised Learning/Model_NN/Main.py:224-239``), the FNN
controller on the L1 imitation loss of the recorded MPC commands
(``Supervised Learning/Main.py:272-286``) or on the MPC loss through the
frozen surrogate (``Unsupervised Learning/Main.py:326-348``).

The JAX package runs each training run as one XLA program; here every
epoch and batch is a Python loop over eager ops, and the host syncs once
per epoch.  The surrogate's training step runs the module's autograd
``forward`` (the kernel has no backward, in either package); its validation
forward runs under no-grad through ``infer``, so on a card it is one kernel
launch per epoch.  The MPC-loss step differentiates the same autograd
forward.  Where the JAX package draws from ``jax.random`` (batch tables,
MPC-loss noise, reference streams, plant noise) the port draws from a
``torch.Generator`` and takes the draws as optional arguments, so parity
runs pass the JAX package's in.  ``train_supervised`` and
``train_surrogate`` take a ``mesh`` (``parallel.mesh``): each rank then
trains on its rows of every batch and the gradients and the loss are
all-reduce-averaged before the step, so the ranks stay in step with the
full batch's run; a batch that does not divide over the ranks stays whole
on every rank, as the JAX package keeps it local.
"""

from __future__ import annotations

import copy
import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import fnn, mpc_loss


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


def _rank_rows(mesh, idx):
    """(this rank's rows of a batch's index table, whether the batch is
    split): the whole batch without a mesh or when its size does not divide
    over the mesh's ranks."""
    if mesh is None or len(idx) % mesh.size:
        return idx, False
    n = len(idx) // mesh.size
    return idx[mesh.rank * n:(mesh.rank + 1) * n], True


def _average_grads(mesh, params) -> None:
    """All-reduce mean of every parameter's gradient, in place."""
    from ..parallel.mesh import all_mean
    params = list(params)
    for v, g in zip(params, all_mean([v.grad for v in params], mesh)):
        v.grad.copy_(g)


def _step_loss(mesh, loss, split):
    """A step's loss for the report: the full batch's when it was split."""
    if not split:
        return loss.detach()
    from ..parallel.mesh import all_mean
    return all_mean(loss, mesh)


def train_supervised(params, x_train, y_train, x_val, y_val, *,
                     width_dim=1, lr=1e-3, weight_decay=1e-2, epochs=20,
                     batch_size=256, loss_fn=l1_loss, seed=0, perms=None,
                     log_fn: Callable | None = None, mesh=None):
    """Supervised imitation trainer: the FNN mimics recorded MPC commands.

    ``params`` (a dict of tensors, ``nn/fnn.py``) is copied and the copy
    trained on its own device; the data (arrays or tensors) are moved there
    and promoted with the weights' dtype, as JAX promotes them.  Returns
    (trained params, :class:`TrainReport`).  ``perms`` and the batch tables
    drawn without it are as in :func:`train_surrogate`; ``torch.optim.AdamW``
    with its defaults is the arithmetic of ``optax.adamw``.  ``mesh``:
    data-parallel batches (see the module docstring)."""
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
            idx, split = _rank_rows(mesh, idx)
            loss = loss_fn(fnn.apply(p, xt[idx], width_dim), yt[idx])
            opt.zero_grad(set_to_none=False)
            loss.backward()
            if split:
                _average_grads(mesh, p.values())
            opt.step()
            losses.append(_step_loss(mesh, loss, split))
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


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable:
    """``optax.cosine_decay_schedule``: update count -> learning rate,
    ``init_value * ((1 - alpha) * (1 + cos(pi * min(t, T) / T)) / 2 +
    alpha)``."""
    if not decay_steps > 0:
        raise ValueError(f"decay_steps must be positive, got {decay_steps}")

    def schedule(count):
        count = min(float(count), float(decay_steps))
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def _adamw(params: dict, lr, weight_decay):
    """``optax.adamw(lr, weight_decay)`` over ``params``: a
    ``torch.optim.AdamW`` and, when ``lr`` is a schedule (update count ->
    rate), the ``LambdaLR`` that steps it.  The first update uses
    ``lr(0)``, as optax's does; the scheduler steps after every applied
    update."""
    if callable(lr):
        opt = torch.optim.AdamW(list(params.values()), lr=1.0,
                                weight_decay=weight_decay)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lr)
    return torch.optim.AdamW(list(params.values()), lr=lr,
                             weight_decay=weight_decay), None


def _grads(loss, params: dict) -> list:
    """Gradients of ``loss`` with respect to every parameter; zeros for
    those it does not use (w_int, b_int at width_dim = 1), since optax
    decays every leaf and AdamW skips a parameter whose gradient is None.
    Nothing else the loss reaches (a frozen surrogate) gets a gradient."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(params.values(), grads)]


def _apply(opt, sched, params: dict, grads: list) -> None:
    for v, g in zip(params.values(), grads):
        v.grad = g
    opt.step()
    if sched is not None:
        sched.step()


def _trainable(params: dict) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in params.items()}


def _detached(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def train_unsupervised(controller_params, surrogate, x_train, u_train,
                       z_train, x_val, u_val, *, horizon=10, alpha=20.0,
                       width_dim=1, lr=1e-4, weight_decay=1e-2, epochs=20,
                       batch_size=15, enable_noise=False, noise_sigma=0.01,
                       seed=0, keep_best=True,
                       closed_loop_val_fn: Callable | None = None,
                       log_fn: Callable | None = None, perms=None,
                       noise=None):
    """MPC-loss trainer: the FNN trained through the frozen LSTM surrogate.

    ``controller_params`` (a dict of tensors) is copied and the copy trained
    on its own device; ``surrogate`` (an ``LSTMSurrogate``) gets no
    gradient.  The data (arrays or tensors) are moved there and keep their
    dtype, which the loss promotes as JAX does.  Validation is the plain
    MSE against the recorded MPC commands (the reference's
    ``Unsupervised Learning/Functions.py:868-888``).  ``keep_best`` returns
    the parameters of the best validation epoch, or with
    ``closed_loop_val_fn(params) -> MAE`` of the best true-plant closed-loop
    epoch (values in ``TrainReport.cl_val_losses``).

    ``lr`` is a rate or a schedule (update count -> rate, e.g.
    :func:`cosine_decay_schedule`).  ``perms`` holds the per-epoch batch
    tables (as in :func:`train_surrogate`); ``noise[epoch][batch]`` the
    (N, B, 4) standard-normal draws of one batch's MPC loss when
    ``enable_noise`` (the JAX package's per-batch ``jax.random`` draws);
    without them both are drawn from a CPU ``torch.Generator`` seeded with
    ``seed``.  Returns (params, :class:`TrainReport`).
    """
    device = controller_params["w_in"].device
    p = _trainable(controller_params)
    xt, zt, xv, uv = (torch.as_tensor(a, device=device)
                      for a in (x_train, z_train, x_val, u_val))
    opt, sched = _adamw(p, lr, weight_decay)
    gen = torch.Generator().manual_seed(seed)

    report = TrainReport()
    best_p, best_v = _detached(p), math.inf
    t0 = time.time()
    for epoch in range(epochs):
        losses = []
        table = _tables(perms, epoch, gen, len(xt), batch_size, device)
        for b, idx in enumerate(table):
            xb, zb = xt[idx], zt[idx]
            draws = (noise[epoch][b] if enable_noise and noise is not None
                     else None)
            loss, _ = mpc_loss.mpc_loss(
                p, surrogate, xb, fnn.apply(p, xb, width_dim), zb,
                horizon=horizon, alpha=alpha, width_dim=width_dim,
                noise=draws, noise_std=noise_sigma,
                generator=gen if enable_noise else None)
            _apply(opt, sched, p, _grads(loss, p))
            losses.append(loss.detach())
        with torch.no_grad():
            vl = float(mse_loss(fnn.apply(p, xv, width_dim), uv))
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(vl)
        if closed_loop_val_fn is None:
            select = vl
        else:
            select = float(closed_loop_val_fn(p))
            report.cl_val_losses.append(select)
        if select < best_v:
            best_p = _detached(p)
        if closed_loop_val_fn is None:
            # The fused JAX run keeps jnp.minimum(vl, best): a NaN sticks.
            best_v = (math.nan if math.isnan(select) or math.isnan(best_v)
                      else min(select, best_v))
        elif select < best_v:
            best_v = select
        if log_fn:
            log_fn(epoch, report.train_losses[-1], select)
    report.wall_time_s = time.time() - t0
    return (best_p if keep_best else _detached(p)), report


# optax.apply_if_finite's max_consecutive_errors in the JAX package's
# plant-in-loop optimizer.
MAX_CONSECUTIVE_ERRORS = 1000


def _clip_by_global_norm(grads: list, keys: list, max_norm: float) -> list:
    """``optax.clip_by_global_norm``: the norm over the leaves in the JAX
    package's order (``keys`` sorted), each leaf scaled by max_norm / norm
    unless the norm is below max_norm."""
    order = sorted(range(len(keys)), key=keys.__getitem__)
    g_norm = torch.sqrt(sum(torch.sum(torch.square(grads[i]))
                            for i in order))
    trigger = g_norm < max_norm
    return [torch.where(trigger, g, (g / g_norm) * max_norm) for g in grads]


def train_plant_in_loop(params, in_scaler, u_scaler, *, width_dim=1,
                        t_steps=300, n_traj=32, steps=300, lr=1e-3,
                        weight_decay=1e-2, rterm=0.02, pressure_weight=1.0,
                        ref_variant="unsupervised", variant="smooth",
                        process_std=(0.0,) * 5, clip_norm=1.0, seed=0,
                        val_every=10, keep_best=True,
                        closed_loop_val_fn: Callable | None = None,
                        log_fn: Callable | None = None, refs=None,
                        noise=None):
    """Analytic-policy-gradient trainer: the FNN trained by
    backpropagation through full closed-loop episodes of the true RK4 plant.

    The objective mirrors the MPC's own (template_mpc.py:44-50):

        mean_t min((y_dot_t - ref_t)^2, 4) + rterm * mean_t (du_t / U_SCALE)^2
        + pressure_weight * mean_t min(relu-barrier(p / 1e7), 10)

    Episodes run with ``state_clip`` (1, 10, 1e9, 1e9, 1).  Each update
    clips the gradient's global norm to ``clip_norm`` and takes an AdamW
    step on a cosine schedule from ``lr`` over ``steps`` (alpha 0.05);
    as optax's ``apply_if_finite`` does, a non-finite gradient applies no
    update and advances neither the schedule nor Adam's count (until
    ``MAX_CONSECUTIVE_ERRORS`` in a row).  A loss that is not finite or
    above 4 x the best so far rewinds the parameters and the optimizer to
    the best-loss snapshot.  ``closed_loop_val_fn`` scores the parameters
    every ``val_every`` steps and at the last; with ``keep_best`` the best
    are returned.

    ``refs`` (steps, n_traj, t_steps) and ``noise`` (steps, n_traj,
    t_steps, 5; process noise, already scaled) replace the per-step draws
    (reference streams from a CPU ``torch.Generator`` seeded with
    ``seed``, which then draws the plant noise), so parity runs pass the
    JAX package's.  The episode reads the live parameters through
    ``fnn.make_policy(..., cache=False)``.  Returns (params,
    :class:`TrainReport`).
    """
    from .. import dual as ad
    from ..loop import closed_loop as cl
    from ..physics.scaling import U_SCALE
    from ..refgen import streams

    device = params["w_in"].device
    dtype = params["w_in"].dtype
    p = _trainable(params)
    # state_clip keeps training episodes finite when a candidate policy
    # excites the stiff pressure dynamics (evaluation paths never clip).
    loop_cfg = cl.LoopConfig(t_steps=t_steps, variant=variant,
                             process_std=tuple(process_std),
                             state_clip=(1.0, 10.0, 1e9, 1e9, 1.0))
    x0 = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(n_traj, 1)
    opt, sched = _adamw(p, cosine_decay_schedule(lr, max(steps, 1),
                                                 alpha=0.05), weight_decay)
    ctrl = cl.FunctionController(fnn.make_policy(p, in_scaler, u_scaler,
                                                 width_dim, cache=False))
    gen = torch.Generator().manual_seed(seed)

    def episode_cost(refs_s, noise_s):
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs_s, gen,
                                process_noise=noise_s, device=device)
        # Saturated per-step tracking cost: one diverged episode must not
        # own the batch gradient.
        err2 = torch.square(telem.x[..., 1] - telem.ref)
        track = torch.mean(ad.minimum(err2, 4.0))
        du = torch.diff(telem.u, dim=-1,
                        prepend=torch.zeros_like(telem.u[:, :1]))
        smooth = rterm * torch.mean(torch.square(du / U_SCALE))
        p_scaled = telem.x[..., 2:4] / 1e7
        barrier = pressure_weight * torch.mean(ad.minimum(
            torch.relu(-p_scaled) + torch.relu(p_scaled - 3.2), 10.0))
        return track + smooth + barrier

    def snapshot(loss):
        return (_detached(p), copy.deepcopy(opt.state_dict()),
                copy.deepcopy(sched.state_dict()), notfinite, loss)

    report = TrainReport()
    best_params, best_val = _detached(p), math.inf
    best_train = math.inf
    notfinite = 0
    snap = snapshot(math.inf)
    t0 = time.time()
    for step in range(steps):
        refs_s = (refs[step] if refs is not None
                  else streams.sample_references(gen, n_traj, ref_variant,
                                                 t_steps, dtype=dtype,
                                                 device=device))
        loss = episode_cost(refs_s, None if noise is None else noise[step])
        grads = _grads(loss, p)
        finite = bool(torch.stack([torch.isfinite(g).all()
                                   for g in grads]).all())
        notfinite = 0 if finite else notfinite + 1
        if finite or notfinite > MAX_CONSECUTIVE_ERRORS:
            _apply(opt, sched, p, _clip_by_global_norm(grads, list(p),
                                                       clip_norm))
        l = float(loss.detach())
        # Rewind on divergence to the best-loss snapshot; the decayed
        # schedule takes a smaller step past the cliff next time.
        if not math.isfinite(l) or (math.isfinite(best_train)
                                    and l > 4.0 * max(best_train, 1e-3)):
            snap_p, snap_opt, snap_sched, notfinite, l = snap
            with torch.no_grad():
                for k, v in p.items():
                    v.copy_(snap_p[k])
            opt.load_state_dict(copy.deepcopy(snap_opt))
            sched.load_state_dict(copy.deepcopy(snap_sched))
        elif l < best_train:
            best_train = l
            snap = snapshot(l)
        report.train_losses.append(l)
        if closed_loop_val_fn is not None and (
                step % val_every == val_every - 1 or step == steps - 1):
            sel = float(closed_loop_val_fn(p))
            report.cl_val_losses.append(sel)
            if sel < best_val:
                best_val = sel
                best_params = _detached(p)
            if log_fn:
                log_fn(step, report.train_losses[-1], sel)
        elif log_fn:
            log_fn(step, report.train_losses[-1], None)
    report.wall_time_s = time.time() - t0
    if keep_best and closed_loop_val_fn is not None:
        return best_params, report
    return _detached(p), report


@torch.no_grad()
def dagger_rollout(params, in_scaler, u_scaler, mpc_cfg, refs, *,
                   width_dim=1, variant="smooth", process_std=(0.0,) * 5,
                   backend="sqp", beta=0.0, dtype=torch.float32,
                   generator: torch.Generator | None = None,
                   process_noise=None):
    """Roll the student policy in closed loop while the MPC teacher labels
    every visited state: the DAgger data-collection pass.

    At each step the teacher (``backend`` "sqp" or "ilqr", warm-started
    along the student's trajectory by the usual shift) solves at the state
    the student visits, but its command is not applied (``beta=0``; beta > 0
    blends it into the applied command).  The loop runs in ``dtype`` on the
    device of ``params``; on a card every damped normal solve of the SQP
    teacher is a launch of kernel B1, ``gn_iters x al_iters`` per step, and
    every step after the first is one replay of a CUDA graph of the step
    (``loop.graph``).  Process noise: ``process_noise`` (B, T, 5, already
    scaled), else drawn from ``generator`` when ``process_std`` is
    nonzero.

    Returns ``(feats (B, T, 3), u_teacher (B, T))`` in raw physical units
    (features [y_dot, z, ref], the supervised controller inputs).
    """
    from ..integrate.rk4 import rk4_step
    from ..loop import closed_loop as cl
    from ..loop import graph

    device = params["w_in"].device
    refs = torch.as_tensor(refs).to(device, dtype)
    B, T = refs.shape
    loop_cfg = cl.LoopConfig(t_steps=T, variant=variant,
                             process_std=tuple(process_std))
    policy = fnn.make_policy(params, in_scaler, u_scaler, width_dim)
    teacher = cl.MPCController(mpc_cfg, backend=backend)
    if process_noise is not None:
        process_noise = torch.as_tensor(process_noise).to(device, dtype)

    def f(x, u):
        return cl.press.rhs(x, u, loop_cfg.params, loop_cfg.variant)

    def measure(x):
        return cl.press.measure(x, loop_cfg.params, loop_cfg.variant)

    def period(state, inputs):
        x_true, x_meas, u_prev, carry = state
        ref, w = inputs
        u_teach, carry, _ = teacher.step_batch(carry, x_meas, ref, u_prev)
        u_stud = policy(x_meas, ref, u_prev).to(dtype)
        u0 = (1.0 - beta) * u_stud + beta * u_teach.to(dtype)
        x_next = rk4_step(f, x_true, u0, loop_cfg.dt, loop_cfg.substeps,
                          disturbance=w)
        feats = torch.stack([x_meas[:, 1], x_meas[:, 4], ref], dim=-1)
        return (x_next, measure(x_next), u0, carry), (feats, u_teach)

    def inputs(t):
        return refs[:, t], cl._noise(loop_cfg.process_std, process_noise, t,
                                     generator, B, dtype, device, "process")

    x_true = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                          device=device).repeat(B, 1)
    state = (x_true, measure(x_true), torch.zeros(B, dtype=dtype,
                                                  device=device),
             teacher.init_carry_batch(B, dtype, device))
    _, outs, _ = graph.run(period, state, inputs, T,
                           graph=None if device.type == "cuda" else False)
    feats, labels = zip(*outs)
    return torch.stack(feats, dim=1), torch.stack(labels, dim=1)


def _float32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def train_dagger(params, in_scaler, u_scaler, x_init, u_init, x_val, u_val,
                 *, mpc_cfg, rounds=3, n_traj=16, t_steps=300,
                 ref_variant="unsupervised", width_dim=1, lr=1e-3,
                 epochs=20, batch_size=256, process_std=(0.0,) * 5,
                 backend="sqp", seed=0, variant="smooth",
                 closed_loop_val_fn: Callable | None = None,
                 log_fn: Callable | None = None, perms=None, refs=None,
                 noise=None):
    """DAgger: iterated imitation with expert relabelling on the student's
    own closed-loop distribution.

    Starts from the recorded teacher dataset (``x_init``/``u_init``, scaled
    units, kept as float32 like every aggregated row), then alternates:
    :func:`train_supervised` on the aggregate -> roll the student on fresh
    reference streams (:func:`dagger_rollout` at its default float32, as
    in the JAX package) -> label every visited state with the batched MPC
    teacher -> aggregate.  The round with the best
    ``closed_loop_val_fn`` score is returned.

    Per round ``r``: ``perms[r]`` are its batch tables (training seed
    ``seed + r``), and before relabelling round ``r``, ``refs[r]`` (n_traj,
    t_steps) and ``noise[r]`` (n_traj, t_steps, 5) replace the draws from a
    CPU ``torch.Generator`` seeded with ``seed + 77``.  Returns (params,
    :class:`TrainReport`).
    """
    from ..refgen import streams

    device = params["w_in"].device
    report = TrainReport()
    t0 = time.time()
    X, U = [_float32(x_init)], [_float32(u_init)]
    best_params, best_val = None, math.inf
    gen = torch.Generator().manual_seed(seed + 77)
    for r in range(rounds):
        params, rep = train_supervised(
            params, np.concatenate(X, axis=0), np.concatenate(U, axis=0),
            x_val, u_val, width_dim=width_dim, lr=lr, epochs=epochs,
            batch_size=batch_size, seed=seed + r,
            perms=None if perms is None else perms[r])
        report.train_losses.extend(rep.train_losses)
        report.val_losses.extend(rep.val_losses)
        if closed_loop_val_fn is not None:
            sel = float(closed_loop_val_fn(params))
            report.cl_val_losses.append(sel)
            if sel < best_val:
                best_val = sel
                best_params = _detached(params)
            if log_fn:
                log_fn(r, rep.train_losses[-1], sel)
        if r == rounds - 1:
            break
        refs_r = (refs[r] if refs is not None
                  else streams.sample_references(gen, n_traj, ref_variant,
                                                 t_steps, dtype=torch.float32,
                                                 device=device))
        feats, labels = dagger_rollout(
            params, in_scaler, u_scaler, mpc_cfg, refs_r,
            width_dim=width_dim, variant=variant, process_std=process_std,
            backend=backend, generator=gen,
            process_noise=None if noise is None else noise[r])
        X.append(_float32(in_scaler.transform(feats.cpu().reshape(-1, 3))))
        U.append(_float32(u_scaler.transform(labels.cpu().reshape(-1, 1))))
    report.wall_time_s = time.time() - t0
    if best_params is not None:
        params = best_params
    return params, report


def train_surrogate(model, x_train, y_train, x_val, y_val, *, lr=1e-3,
                    weight_decay=1e-2, epochs=50, batch_size=256, seed=0,
                    perms=None, log_fn: Callable | None = None, mesh=None):
    """LSTM surrogate trainer: teacher-forced next-step MSE.

    ``model`` (an ``LSTMSurrogate``) is trained in place on its own device
    and returned with a :class:`TrainReport`.  The data are tensors on that
    device.  ``perms``, if given, holds one (n_batches, batch_size) index
    table per epoch (e.g. the JAX package's); otherwise they are drawn from
    a CPU ``torch.Generator`` seeded with ``seed``.  ``log_fn(epoch,
    train_loss, val_loss)`` is called after each epoch.

    ``torch.optim.AdamW(lr, weight_decay)`` with its defaults (beta =
    0.9/0.999, eps = 1e-8, decay on every parameter) is the arithmetic of
    ``optax.adamw``.  ``mesh``: data-parallel batches (see the module
    docstring).
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
            idx, split = _rank_rows(mesh, idx)
            loss = mse_loss(model(x_train[idx]), y_train[idx])
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if split:
                _average_grads(mesh, model.parameters())
            opt.step()
            losses.append(_step_loss(mesh, loss, split))
        val = mse_loss(model.infer(x_val), y_val)
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(float(val))
        if log_fn:
            log_fn(epoch, report.train_losses[-1], report.val_losses[-1])
    report.wall_time_s = time.time() - t0
    return model, report
