"""Scenario-batch parallelism over ``torch.distributed`` ranks.

Port of ``forging_control_tpu/parallel/mesh.py``.  The reference has no
parallelism (one Python process, 24,000 serial IPOPT solves per dataset,
SURVEY.md section 2.10).  Trajectories are independent, so the batch's
scenario axis splits over a 1-D mesh of ranks:

* each rank runs the closed loop (``loop.run_batch``) on its contiguous
  rows of the batch, with no communication per step;
* metric reductions and gradient averaging are all-reduces.

A :class:`Mesh` holds no devices of its own: it is the default process
group's ranks, this process's rank, and the device its rows live on.
Tensors stay plain local tensors (no ``DTensor``).  Every collective here is
an ``all_reduce`` or a ``broadcast``, which gloo offers for CPU and CUDA
tensors and NCCL for CUDA tensors.  With no process group up, a mesh has
one rank and its collectives do nothing.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..device import resolve_device

SCENARIO_AXIS = "scenario"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ``size`` ranks on axis ``axis``; this process is rank
    ``rank`` and keeps its rows on ``device``."""

    axis: str
    size: int
    rank: int
    device: torch.device


def _group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def make_mesh(axis: str = SCENARIO_AXIS, device="cuda") -> Mesh:
    """The mesh over every rank of the default process group (one rank
    when none is up), this rank's rows on ``device``."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    size, rank = ((dist.get_world_size(), dist.get_rank()) if _group_up()
                  else (1, 0))
    return Mesh(axis, size, rank, device)


def default_mesh(axis: str = SCENARIO_AXIS, device="cuda") -> Mesh | None:
    """The mesh over all ranks, or None unless a process group of more than
    one rank is up.  The trainers and pipelines treat None as no sharding,
    so a run on one card is unchanged."""
    if _group_up() and dist.get_world_size() > 1:
        return make_mesh(axis=axis, device=device)
    return None


def _tree_map(fn, tree):
    """``fn`` on every leaf of a tree of dicts, lists, tuples and
    NamedTuples (``utils.checkpoint``'s tree order); None stays None."""
    from ..utils.checkpoint import _flatten, _unflatten
    return _unflatten(tree, iter([fn(leaf) for leaf in _flatten(tree)]))


def _all_reduce(mesh: Mesh, x: torch.Tensor, op=None) -> torch.Tensor:
    """In-place all-reduce of ``x`` over the mesh (a sum by default)."""
    if _group_up():
        dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op)
    elif mesh.size != 1:
        raise RuntimeError(f"a mesh of {mesh.size} ranks needs its process "
                           "group")
    return x


def shard_scenarios(mesh: Mesh, tree):
    """This rank's contiguous rows of each leaf (tensor or array, batch
    first), on the mesh's device.  The batch must divide evenly over the
    ranks, as the JAX package's sharding requires."""

    def rows(x):
        x = torch.as_tensor(x)
        if x.shape[0] % mesh.size:
            raise ValueError(f"batch of {x.shape[0]} does not divide over "
                             f"{mesh.size} ranks")
        n = x.shape[0] // mesh.size
        return x[mesh.rank * n:(mesh.rank + 1) * n].to(mesh.device)

    return _tree_map(rows, tree)


def replicate(mesh: Mesh, tree):
    """Every leaf as rank 0 holds it, on every rank (a broadcast)."""

    def bcast(x):
        x = torch.as_tensor(x).to(mesh.device).contiguous().clone()
        if _group_up():
            dist.broadcast(x, src=0)
        return x

    return _tree_map(bcast, tree)


def sharded_closed_loop(loop_cfg, controller, mesh: Mesh):
    """The batched closed loop over this rank's rows of a scenario batch.

    Returns ``run(x0, refs, generator=None, *, process_noise=None,
    meas_noise=None) -> (x_final, Telemetry)``, where x0 (b, 5) and refs
    (b, T) are this rank's rows (:func:`shard_scenarios` or
    ``launcher.host_local_batch_to_global``) of a batch of b x mesh.size.
    Noise that is not given pre-drawn for these rows ((b, T, 5)) is drawn
    as ``run_batch`` draws it in one process, for the whole batch, step by
    step from ``generator`` (in the same state on every rank), and each
    rank keeps its rows: the sharded run then equals the one-process run,
    with no communication.
    """
    from ..loop import closed_loop as cl

    def run(x0, refs, generator=None, *, process_noise=None,
            meas_noise=None):
        x0 = torch.as_tensor(x0, device=mesh.device)
        b, dtype = x0.shape[0], x0.dtype
        stds = (loop_cfg.process_std, loop_cfg.meas_std)
        given = (process_noise, meas_noise)
        drawn = ([], [])
        for t in range(loop_cfg.t_steps):
            for std, g, d, what in zip(stds, given, drawn,
                                       ("process", "measurement")):
                if g is None:
                    d.append(cl._noise(std, None, t, generator,
                                       b * mesh.size, dtype, mesh.device,
                                       what))
        lo = mesh.rank * b
        noise = [torch.as_tensor(g, device=mesh.device).to(dtype)
                 if g is not None else torch.stack(d, 1)[lo:lo + b]
                 for g, d in zip(given, drawn)]
        return cl.run_batch(loop_cfg, controller, x0, refs,
                            process_noise=noise[0], meas_noise=noise[1],
                            device=mesh.device)

    return run


def all_mean(tree, mesh: Mesh):
    """All-reduce mean of every leaf across the mesh's ranks."""

    def mean(x):
        x = torch.as_tensor(x).detach().clone()
        return _all_reduce(mesh, x) / mesh.size

    return _tree_map(mean, tree)


def data_parallel_update(mesh: Mesh, loss_fn, optimizer):
    """A data-parallel training step: ``step(params, batch) -> loss``.

    ``loss_fn(params, batch)`` is a scalar; ``params`` (a dict or list of
    tensors) are the parameters ``optimizer`` updates, the same on every
    rank; ``batch`` is this rank's rows (:func:`shard_scenarios` or
    ``launcher.host_local_batch_to_global``).  The loss and every
    parameter's gradient (zero for a parameter the loss does not use, which
    AdamW then still decays, as optax does) are all-reduce-averaged before
    the optimizer's step, so on equal shards the step is the full batch's.
    """

    def step(params, batch):
        leaves = list(params.values() if isinstance(params, dict)
                      else params)
        loss = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        for p, g in zip(leaves, all_mean(grads, mesh)):
            p.grad = g
        optimizer.step()
        return all_mean(loss, mesh)

    return step


def sharded_metrics(mesh: Mesh):
    """Tracking metrics over the whole batch from each rank's rows: each
    rank sums its rows, one all-reduce of (n, sum |e|, sum e^2, sum ref,
    sum ref^2) completes them, and MAE, RMSE and R^2 follow as the JAX
    package computes them.  Returns ``metrics(ref, y_dot)`` -> a dict of
    0-d tensors, the same on every rank."""

    def metrics(ref, y_dot):
        ref = torch.as_tensor(ref)
        err = ref - torch.as_tensor(y_dot, device=ref.device)
        sums = torch.stack([
            torch.tensor(ref.numel(), dtype=ref.dtype, device=ref.device),
            torch.sum(torch.abs(err)), torch.sum(err ** 2), torch.sum(ref),
            torch.sum(ref ** 2)])
        n, s_abs, s_sq, s_ref, s_ref2 = _all_reduce(mesh, sums)
        mean_ref = s_ref / n
        ss_tot = s_ref2 - n * mean_ref ** 2
        return {"MAE": s_abs / n, "RMSE": torch.sqrt(s_sq / n),
                "R2": 1.0 - s_sq / ss_tot}

    return metrics
