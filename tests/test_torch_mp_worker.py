"""Worker process of the two-process gloo run in ``test_torch_parallel.py``;
this file holds no tests and imports no jax.

Each process is one rank of a gloo group on the CPU and owns 2 of the B = 4
scenarios.  It runs the port's multi-process leg end to end:
``launcher.initialize`` -> ``global_scenario_mesh`` ->
``host_local_batch_to_global`` -> the scenario-sharded closed-loop MPC (the
condensed GN-SQP, the AL-iLQR, and the SQP with process noise drawn from one
generator) -> the all-reduce metrics -> one data-parallel training step and
one ``train_supervised(mesh=...)`` run; it dumps its rows and the replicated
results as JSON.

Usage: python tests/test_torch_mp_worker.py <rank> <world_size> <port> <out>
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

B, T = 4, 6
PROCESS_STD = (5e-1, 2e0, 5e7, 5e7, 2e0)


def batch():
    """The whole batch: x0 (B, 5) at X0_REFERENCE, refs (B, T) held at
    -0.6 ... 0.6."""
    import numpy as np

    from forging_control_tpu_torch.physics.press import X0_REFERENCE
    x0 = np.tile(np.asarray(X0_REFERENCE, np.float64), (B, 1))
    refs = np.linspace(-0.6, 0.6, B)[:, None] * np.ones((1, T))
    return x0, refs


def controllers():
    from forging_control_tpu_torch.loop import closed_loop as cl
    from forging_control_tpu_torch.solver import sqp
    cfg = sqp.MPCConfig(horizon=5, variant="smooth", gn_iters=2, al_iters=1)
    return {"sqp": cl.MPCController(cfg),
            "ilqr": cl.MPCController(cfg, backend="ilqr")}


def loop_configs():
    from forging_control_tpu_torch.loop import closed_loop as cl
    return {"clean": cl.LoopConfig(t_steps=T, variant="smooth"),
            "noisy": cl.LoopConfig(t_steps=T, variant="smooth",
                                   process_std=PROCESS_STD)}


def dp_data():
    """8 training rows and an FNN of hidden width 8, float64."""
    import numpy as np
    import torch

    from forging_control_tpu_torch.nn import fnn
    x = np.linspace(-1.0, 1.0, 8 * 3).reshape(8, 3)
    y = np.tanh(x.sum(axis=1, keepdims=True))
    params = fnn.init(torch.Generator().manual_seed(0), hidden_dim=8,
                      dtype=torch.float64, device="cpu")[0]
    return x, y, params


def main():
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])

    import torch

    from forging_control_tpu_torch.nn import fnn, train
    from forging_control_tpu_torch.parallel import launcher, mesh as pmesh

    launcher.initialize(coordinator_address=f"localhost:{port}",
                        num_processes=world, process_id=rank, device="cpu")
    mesh = launcher.global_scenario_mesh(device="cpu")
    assert (mesh.size, mesh.rank) == (world, rank)
    assert pmesh.default_mesh(device="cpu") == mesh

    rows = B // world
    lo = rank * rows
    x0_all, refs_all = batch()
    x0, refs = launcher.host_local_batch_to_global(
        mesh, (x0_all[lo:lo + rows], refs_all[lo:lo + rows]))
    res = {"rank": rank, "world": world}
    ctrls, loops = controllers(), loop_configs()
    for name, ctrl, loop_cfg in (("sqp", ctrls["sqp"], loops["clean"]),
                                 ("ilqr", ctrls["ilqr"], loops["clean"]),
                                 ("sqp_noisy", ctrls["sqp"],
                                  loops["noisy"])):
        gen = torch.Generator().manual_seed(3)
        _, telem = pmesh.sharded_closed_loop(loop_cfg, ctrl, mesh)(
            x0, refs, gen)
        m = pmesh.sharded_metrics(mesh)(telem.ref, telem.x[..., 1])
        res[name] = {"u": telem.u.tolist(), "w": telem.w.tolist(),
                     "u_mean": float(pmesh.all_mean(telem.u.mean(), mesh)),
                     **{k: float(v) for k, v in m.items()}}

    x, y, params = dp_data()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    step = pmesh.data_parallel_update(
        mesh, lambda pp, b: train.l1_loss(fnn.apply(pp, b[0]), b[1]),
        torch.optim.AdamW(list(p.values()), lr=1e-3, weight_decay=1e-2))
    loss = step(p, pmesh.shard_scenarios(mesh, (x, y)))
    res["dp"] = {"loss": float(loss),
                 "params": {k: v.detach().tolist() for k, v in p.items()}}
    trained, rep = train.train_supervised(params, x, y, x, y, epochs=2,
                                          batch_size=4, mesh=mesh)
    res["train"] = {"losses": rep.train_losses, "val": rep.val_losses,
                    "params": {k: v.tolist() for k, v in trained.items()}}
    with open(out, "w") as f:
        json.dump(res, f)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
