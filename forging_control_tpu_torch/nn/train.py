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

The JAX package runs each training run as one XLA program; here epochs
and batches are a Python loop, and the host syncs once per epoch (the
plant-in-loop trainer once per step).  On a card each training step
(forward, backward through ``torch.autograd.grad``, gradient clipping and
the optimizer update of ``nn/optim.py``, the counterpart of the optax
pieces) is one replay of a CUDA graph, captured after the first, eager
step (``loop.graph.Step``); its inputs (the batch's index row, noise and
reference draws) are copied into static buffers outside the graph.  The
surrogate's training step runs the module's autograd
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
on every rank, as the JAX package keeps it local.  Such a run stays eager:
its all-reduce (gloo, or NCCL) is not captured.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from . import fnn, mpc_loss, optim


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


def _splits(mesh, batch_size: int) -> bool:
    """Whether a batch is split over the mesh's ranks: not without a mesh,
    nor when its size does not divide over the ranks."""
    return mesh is not None and batch_size % mesh.size == 0


def _rank_rows(mesh, idx):
    """This rank's rows of a batch's index row: all of them unless the
    batch is split."""
    if not _splits(mesh, len(idx)):
        return idx
    n = len(idx) // mesh.size
    return idx[mesh.rank * n:(mesh.rank + 1) * n]


def _captures(graph, device, mesh=None) -> bool:
    """Whether a trainer runs its steps as replays of a CUDA graph
    (``loop.graph.resolve``).  A run with a mesh stays eager: its gradient
    all-reduce (gloo or NCCL) is not captured, and ``graph=True`` raises."""
    if mesh is not None:
        if graph:
            raise ValueError("graph=True with mesh=: the gradient all-reduce "
                             "is not captured; run with graph=None or False")
        return False
    from ..loop import graph as graph_mod
    return graph_mod.resolve(graph, device)


def _grads(loss, params: list) -> list:
    """Gradients of ``loss`` with respect to every parameter; zeros for
    those it does not use (w_int, b_int at width_dim = 1), since optax
    decays every leaf.  Nothing else the loss reaches (a frozen surrogate)
    gets a gradient, and no ``.grad`` is written."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(v) if g is None else g
            for v, g in zip(params, grads)]


def _trainer_step(loss_fn, tx, params, *, graph: bool, mesh=None):
    """A :class:`loop.graph.Step` from copies of ``params`` (a dict, taken
    in the JAX package's leaf order, sorted keys, or a list) and ``tx``'s
    initial state; ``loss_fn(parameters, inputs) -> loss``.  Its body takes
    the gradients by ``torch.autograd.grad`` from parameters that alias the
    state's, all-reduce-averages them and the loss over ``mesh`` when given,
    and applies ``tx``'s update; it returns ((new parameters, new optimizer
    state), loss)."""
    from ..loop import graph as graph_mod

    def body(state, inputs):
        params, opt_state = state
        live = graph_mod.tree_map(
            lambda v: v.detach().requires_grad_(True), params)
        leaves = graph_mod.leaves(live)
        loss = loss_fn(live, inputs)
        grads = _grads(loss, leaves)
        loss = loss.detach()
        if mesh is not None:
            from ..parallel.mesh import all_mean
            grads, loss = all_mean(grads, mesh), all_mean(loss, mesh)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state, leaves)
            new = optim.apply_updates(leaves, updates)
        if isinstance(params, dict):
            new = dict(zip(params, new))
        return (new, opt_state), loss

    if isinstance(params, dict):
        params = {k: params[k].detach() for k in sorted(params)}
    else:
        params = [v.detach() for v in params]
    state = (params, tx.init(graph_mod.leaves(params)))
    return graph_mod.Step(body, state, graph=graph)


def train_supervised(params, x_train, y_train, x_val, y_val, *,
                     width_dim=1, lr=1e-3, weight_decay=1e-2, epochs=20,
                     batch_size=256, loss_fn=l1_loss, seed=0, perms=None,
                     log_fn: Callable | None = None, mesh=None,
                     graph: bool | None = None):
    """Supervised imitation trainer: the FNN mimics recorded MPC commands.

    ``params`` (a dict of tensors, ``nn/fnn.py``) is copied and the copy
    trained on its own device; the data (arrays or tensors) are moved there
    and promoted with the weights' dtype, as JAX promotes them.  Returns
    (trained params, :class:`TrainReport`).  ``perms`` and the batch tables
    drawn without it are as in :func:`train_surrogate`; ``optim.adamw`` is
    the arithmetic of ``optax.adamw``.  ``mesh``: data-parallel batches
    (see the module docstring), eager.  ``graph``: every step (forward,
    backward, AdamW) after the first is one replay of a CUDA graph
    (``loop.graph.Step``); None captures on a card, False is the eager
    reference, True needs a card and no mesh."""
    device = params["w_in"].device
    captures = _captures(graph, device, mesh)

    def data(a):
        a = torch.as_tensor(a, device=device)
        return a.to(torch.promote_types(a.dtype, params["w_in"].dtype))

    xt, yt, xv, yv = map(data, (x_train, y_train, x_val, y_val))
    split = _splits(mesh, min(batch_size, len(xt)))

    def batch_loss(p, idx):
        idx = _rank_rows(mesh, idx)
        return loss_fn(fnn.apply(p, xt[idx], width_dim), yt[idx])

    step = _trainer_step(batch_loss, optim.adamw(lr, weight_decay), params,
                         graph=captures, mesh=mesh if split else None)
    gen = torch.Generator().manual_seed(seed)

    report = TrainReport()
    t0 = time.time()
    for epoch in range(epochs):
        losses = [step(idx) for idx in
                  _tables(perms, epoch, gen, len(xt), batch_size, device)]
        with torch.no_grad():
            val = loss_fn(fnn.apply(step.state[0], xv, width_dim), yv)
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(float(val))
        if log_fn:
            log_fn(epoch, report.train_losses[-1], report.val_losses[-1])
    report.wall_time_s = time.time() - t0
    return {k: step.state[0][k].clone() for k in params}, report


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
    # One controller for every call, whose policy reads these buffers: a
    # call copies its candidate in, so run_batch's graph cache (keyed by
    # the controller) replays the period captured at the first call.
    weights, ctrl = {}, None

    @torch.no_grad()
    def val(params):
        nonlocal ctrl
        if ctrl is None:
            weights.update({k: v.detach().to(device, dtype, copy=True)
                            for k, v in params.items()})
            ctrl = cl.FunctionController(
                fnn.make_policy(weights, in_scaler, u_scaler, width_dim))
        for k, v in params.items():
            weights[k].copy_(v)
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs,
                                torch.Generator().manual_seed(seed + 9001),
                                device=device)
        return metrics.mae(telem.ref, telem.x[..., 1])

    return val


cosine_decay_schedule = optim.cosine_decay_schedule


def _tensor(a, device, dtype) -> torch.Tensor:
    """An array or tensor as a tensor on ``device`` in ``dtype``."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.array(a))
    return a.to(device, dtype)


def _detached(params: dict) -> dict:
    return {k: v.detach().clone() for k, v in params.items()}


def train_unsupervised(controller_params, surrogate, x_train, u_train,
                       z_train, x_val, u_val, *, horizon=10, alpha=20.0,
                       width_dim=1, lr=1e-4, weight_decay=1e-2, epochs=20,
                       batch_size=15, enable_noise=False, noise_sigma=0.01,
                       seed=0, keep_best=True,
                       closed_loop_val_fn: Callable | None = None,
                       log_fn: Callable | None = None, perms=None,
                       noise=None, graph: bool | None = None):
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
    ``seed``, each batch's noise before its step, outside the step.
    ``graph``: as in :func:`train_supervised`; the validation and the
    closed-loop selection run outside the step's graph.  Returns (params,
    :class:`TrainReport`).
    """
    device = controller_params["w_in"].device
    captures = _captures(graph, device)
    xt, zt, xv, uv = (torch.as_tensor(a, device=device)
                      for a in (x_train, z_train, x_val, u_val))
    noise_dtype = torch.promote_types(zt.dtype, surrogate.w_out.dtype)

    def batch_loss(p, inputs):
        idx, draws = inputs
        xb, zb = xt[idx], zt[idx]
        return mpc_loss.mpc_loss(
            p, surrogate, xb, fnn.apply(p, xb, width_dim), zb,
            horizon=horizon, alpha=alpha, width_dim=width_dim, noise=draws,
            noise_std=noise_sigma)[0]

    def batch_noise(epoch, b, n):
        if not enable_noise:
            return None
        if noise is not None:
            return _tensor(noise[epoch][b], device, noise_dtype)
        return torch.randn(horizon, n, 4, generator=gen,
                           dtype=noise_dtype).to(device)

    step = _trainer_step(batch_loss, optim.adamw(lr, weight_decay),
                         controller_params, graph=captures)
    gen = torch.Generator().manual_seed(seed)

    report = TrainReport()
    best_p, best_v = _detached(controller_params), math.inf
    t0 = time.time()
    for epoch in range(epochs):
        table = _tables(perms, epoch, gen, len(xt), batch_size, device)
        losses = [step((idx, batch_noise(epoch, b, len(idx))))
                  for b, idx in enumerate(table)]
        p = {k: step.state[0][k] for k in controller_params}
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


def train_plant_in_loop(params, in_scaler, u_scaler, *, width_dim=1,
                        t_steps=300, n_traj=32, steps=300, lr=1e-3,
                        weight_decay=1e-2, rterm=0.02, pressure_weight=1.0,
                        ref_variant="unsupervised", variant="smooth",
                        process_std=(0.0,) * 5, clip_norm=1.0, seed=0,
                        val_every=10, keep_best=True,
                        closed_loop_val_fn: Callable | None = None,
                        log_fn: Callable | None = None, refs=None,
                        noise=None, graph: bool | None = None):
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
    JAX package's.  Both are drawn before the step, outside it, in the
    eager loop's order.  The episode reads the live parameters through
    ``fnn.make_policy(..., cache=False)``.

    ``graph``: as in :func:`train_supervised`.  On a card the whole step
    (the ``t_steps`` periods of the closed loop, whose ``run_batch`` runs
    eagerly inside the capture, the backward pass through them, the
    clipping and the update under ``optim.apply_if_finite``) is one CUDA
    graph, replayed from the second step on; its pool holds every saved
    activation of the episode.  The divergence rewind stays on the host
    after each step (one read of the loss), and copies its snapshot into
    the step's buffers.  Returns (params, :class:`TrainReport`).
    """
    from .. import dual as ad
    from ..loop import closed_loop as cl
    from ..loop import graph as graph_mod
    from ..physics.scaling import U_SCALE
    from ..refgen import streams
    from .scalers import Scaler

    device = params["w_in"].device
    dtype = params["w_in"].dtype
    captures = _captures(graph, device)
    # state_clip keeps training episodes finite when a candidate policy
    # excites the stiff pressure dynamics (evaluation paths never clip).
    loop_cfg = cl.LoopConfig(t_steps=t_steps, variant=variant,
                             process_std=tuple(process_std),
                             state_clip=(1.0, 10.0, 1e9, 1e9, 1.0))
    x0 = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(n_traj, 1)
    # The policy casts the scalers to the loop's device and dtype at every
    # period: have them there, so a captured period copies nothing in.
    in_sc, u_sc = (Scaler(*(torch.as_tensor(t).to(device, dtype)
                            for t in sc)) for sc in (in_scaler, u_scaler))
    tx = optim.apply_if_finite(optim.chain(
        optim.clip_by_global_norm(clip_norm),
        optim.adamw(cosine_decay_schedule(lr, max(steps, 1), alpha=0.05),
                    weight_decay)), MAX_CONSECUTIVE_ERRORS)
    gen = torch.Generator().manual_seed(seed)

    def episode_cost(p, inputs):
        refs_s, noise_s = inputs
        ctrl = cl.FunctionController(fnn.make_policy(p, in_sc, u_sc,
                                                     width_dim, cache=False))
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs_s,
                                process_noise=noise_s, device=device,
                                graph=False)
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

    def draws(step):
        """The step's references (n_traj, t_steps) and plant noise
        (n_traj, t_steps, 5; None without noise), on the device: the given
        ones, else drawn from ``gen`` (the references first)."""
        refs_s = (_tensor(refs[step], device, dtype) if refs is not None
                  else streams.sample_references(gen, n_traj, ref_variant,
                                                 t_steps, dtype=dtype,
                                                 device=device))
        if noise is not None:
            return refs_s, _tensor(noise[step], device, dtype)
        return refs_s, cl.draw_noise(loop_cfg, gen, n_traj, dtype, device)[0]

    step_fn = _trainer_step(episode_cost, tx, params, graph=captures)

    report = TrainReport()
    best_params, best_val = _detached(params), math.inf
    best_train = math.inf
    snap = graph_mod.tree_map(torch.clone, step_fn.state), math.inf
    t0 = time.time()
    for step in range(steps):
        l = float(step_fn(draws(step)))
        # Rewind on divergence to the best-loss snapshot (the parameters
        # and the optimizer's state); the decayed schedule takes a smaller
        # step past the cliff next time.
        if not math.isfinite(l) or (math.isfinite(best_train)
                                    and l > 4.0 * max(best_train, 1e-3)):
            graph_mod.copy_into(step_fn.state, snap[0])
            l = snap[1]
        elif l < best_train:
            best_train = l
            snap = graph_mod.tree_map(torch.clone, step_fn.state), l
        report.train_losses.append(l)
        p = {k: step_fn.state[0][k] for k in params}
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
    return _detached({k: step_fn.state[0][k] for k in params}), report


@torch.no_grad()
def dagger_rollout(params, in_scaler, u_scaler, mpc_cfg, refs, *,
                   width_dim=1, variant="smooth", process_std=(0.0,) * 5,
                   backend="sqp", beta=0.0, dtype=torch.float32,
                   generator: torch.Generator | None = None,
                   process_noise=None, graph: bool | None = None):
    """Roll the student policy in closed loop while the MPC teacher labels
    every visited state: the DAgger data-collection pass.

    At each step the teacher (``backend`` "sqp" or "ilqr", warm-started
    along the student's trajectory by the usual shift) solves at the state
    the student visits, but its command is not applied (``beta=0``; beta > 0
    blends it into the applied command).  The loop runs in ``dtype`` on the
    device of ``params``; on a card every damped normal solve of the SQP
    teacher is a launch of kernel B1, ``gn_iters x al_iters`` per step (an
    AL-iLQR teacher's whole solve one launch of kernel K5), the plant step
    one launch of kernel K4, and
    every step after the first is one replay of a CUDA graph of the step
    (``loop.graph``; ``graph`` as in :func:`train_supervised`).  Process
    noise: ``process_noise`` (B, T, 5, already
    scaled), else drawn from ``generator`` when ``process_std`` is
    nonzero.

    Returns ``(feats (B, T, 3), u_teacher (B, T))`` in raw physical units
    (features [y_dot, z, ref], the supervised controller inputs).
    """
    from ..loop import closed_loop as cl
    from ..loop import graph as graph_mod
    from ..ops import plant

    device = params["w_in"].device
    refs = torch.as_tensor(refs).to(device, dtype)
    B, T = refs.shape
    loop_cfg = cl.LoopConfig(t_steps=T, variant=variant,
                             process_std=tuple(process_std))
    policy = fnn.make_policy(params, in_scaler, u_scaler, width_dim)
    teacher = cl.MPCController(mpc_cfg, backend=backend)
    if process_noise is not None:
        process_noise = torch.as_tensor(process_noise).to(device, dtype)

    def measure(x):
        return cl.press.measure(x, loop_cfg.params, loop_cfg.variant)

    def period(state, inputs):
        x_true, x_meas, u_prev, carry = state
        ref, w = inputs
        u_teach, carry, _ = teacher.step_batch(carry, x_meas, ref, u_prev)
        u_stud = policy(x_meas, ref, u_prev).to(dtype)
        u0 = (1.0 - beta) * u_stud + beta * u_teach.to(dtype)
        x_next, x_meas_next, _ = plant.plant_step(loop_cfg, x_true, x_meas,
                                                  u0, w, None)
        feats = torch.stack([x_meas[:, 1], x_meas[:, 4], ref], dim=-1)
        return (x_next, x_meas_next, u0, carry), (feats, u_teach)

    def inputs(t):
        return refs[:, t], cl._noise(loop_cfg.process_std, process_noise, t,
                                     generator, B, dtype, device, "process")

    x_true = torch.tensor(cl.press.X0_REFERENCE, dtype=dtype,
                          device=device).repeat(B, 1)
    state = (x_true, measure(x_true), torch.zeros(B, dtype=dtype,
                                                  device=device),
             teacher.init_carry_batch(B, dtype, device))
    _, outs, _ = graph_mod.run(period, state, inputs, T,
                               graph=graph_mod.resolve(graph, device))
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
                 noise=None, graph: bool | None = None):
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
    CPU ``torch.Generator`` seeded with ``seed + 77``.  ``graph``: passed
    to both (the imitation steps and the rollout's periods replay CUDA
    graphs on a card).  Returns (params, :class:`TrainReport`).
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
            perms=None if perms is None else perms[r], graph=graph)
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
            process_noise=None if noise is None else noise[r], graph=graph)
        X.append(_float32(in_scaler.transform(feats.cpu().reshape(-1, 3))))
        U.append(_float32(u_scaler.transform(labels.cpu().reshape(-1, 1))))
    report.wall_time_s = time.time() - t0
    if best_params is not None:
        params = best_params
    return params, report


def train_surrogate(model, x_train, y_train, x_val, y_val, *, lr=1e-3,
                    weight_decay=1e-2, epochs=50, batch_size=256, seed=0,
                    perms=None, log_fn: Callable | None = None, mesh=None,
                    graph: bool | None = None):
    """LSTM surrogate trainer: teacher-forced next-step MSE.

    ``model`` (an ``LSTMSurrogate``) is trained in place on its own device
    and returned with a :class:`TrainReport`.  The data are tensors on that
    device.  ``perms``, if given, holds one (n_batches, batch_size) index
    table per epoch (e.g. the JAX package's); otherwise they are drawn from
    a CPU ``torch.Generator`` seeded with ``seed``, and each epoch's table
    is copied to the device once.  ``log_fn(epoch, train_loss, val_loss)``
    is called after each epoch.

    ``optim.adamw(lr, weight_decay)`` (beta = 0.9/0.999, eps = 1e-8, decay
    on every parameter) is the arithmetic of ``optax.adamw``.  The step
    differentiates the plain LSTM (``LSTMSurrogate.forward``); the
    per-epoch validation runs ``infer`` (kernel B2 on a card) after the
    trained weights are copied into the model.  ``mesh``: data-parallel
    batches (see the module docstring), eager.  ``graph``: as in
    :func:`train_supervised`.
    """
    from ..ops import lstm as lstm_ops

    device = x_train.device
    captures = _captures(graph, device, mesh)
    n = x_train.shape[0]
    L = len(model.w_ih)
    split = _splits(mesh, min(batch_size, n))
    w_ih, w_hh, w_out, b_out = model.weights()
    weights = [*w_ih, *w_hh, w_out, *([] if b_out is None else [b_out])]

    def batch_loss(p, idx):
        idx = _rank_rows(mesh, idx)
        return mse_loss(lstm_ops.lstm_forward_torch(
            x_train[idx], p[:L], p[L:2 * L], p[2 * L], *p[2 * L + 1:]),
            y_train[idx])

    step = _trainer_step(batch_loss, optim.adamw(lr, weight_decay),
                         weights, graph=captures,
                         mesh=mesh if split else None)
    gen = torch.Generator().manual_seed(seed)

    report = TrainReport()
    t0 = time.time()
    for epoch in range(epochs):
        losses = [step(idx)
                  for idx in _tables(perms, epoch, gen, n, batch_size, device)]
        with torch.no_grad():
            for v, trained in zip(weights, step.state[0]):
                v.copy_(trained)
        val = mse_loss(model.infer(x_val), y_val)
        report.train_losses.append(float(torch.stack(losses).mean()))
        report.val_losses.append(float(val))
        if log_fn:
            log_fn(epoch, report.train_losses[-1], report.val_losses[-1])
    report.wall_time_s = time.time() - t0
    return model, report
