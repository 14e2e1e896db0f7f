"""Multi-process launch helpers.

Port of ``forging_control_tpu/parallel/launcher.py`` over
``torch.distributed``.  The reference is single-process (SURVEY.md section
2.10).  Scaling out is: call :func:`initialize` in every process, build one
1-D mesh over all ranks (:func:`global_scenario_mesh`), and hand each rank
its rows of the scenario batch (:func:`host_local_batch_to_global`).  The
closed-loop engine and trainers take that mesh (``parallel/mesh.py``), and
only metric and gradient reductions communicate.

A run of one process needs none of it: :func:`initialize` is then a no-op,
and ``mesh.default_mesh`` returns None.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> None:
    """``torch.distributed.init_process_group`` over
    ``tcp://coordinator_address`` (``host:port``, rank 0's) with
    ``num_processes`` ranks, this one ``process_id``: NCCL when ``device``
    is a card, gloo when it is the CPU (never switched on its own).  A
    no-op for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    device = resolve_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)


def global_scenario_mesh(axis: str = "scenario", device="cuda"):
    """One 1-D mesh over every rank (one rank if no group is up)."""
    from .mesh import make_mesh
    return make_mesh(axis=axis, device=device)


def host_local_batch_to_global(mesh, local_batch):
    """This rank's share of a scenario batch, as tensors on the mesh's
    device.  Every rank must hold the same number of rows (the mesh's
    batch axis splits evenly, as the JAX package's sharding requires): an
    all-reduce of the sizes checks it.  The batch is ``local_batch``'s tree
    (tensors or arrays, rows first)."""
    from .mesh import _all_reduce, _tree_map

    def local(x):
        x = torch.as_tensor(x, device=mesh.device)
        n = torch.tensor([x.shape[0], -x.shape[0]], dtype=torch.int64,
                         device=mesh.device)
        _all_reduce(mesh, n, dist.ReduceOp.MAX)
        if n[0] != -n[1]:
            raise ValueError(f"ranks hold from {-int(n[1])} to {int(n[0])} "
                             "rows: every rank needs an equal share")
        return x

    return _tree_map(local, local_batch)
