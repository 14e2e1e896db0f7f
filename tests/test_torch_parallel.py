"""The port's scenario parallelism (``parallel/``) against the JAX package's
(float64, CPU), as ``tests/test_parallel.py`` and
``tests/test_cli_launcher.py`` hold the JAX package's: the mesh helpers in
a one-rank gloo group; ``sharded_metrics`` against ``eval.metrics``;
``data_parallel_update`` against the JAX package's full-batch AdamW step;
``train_supervised`` and ``train_surrogate`` with a mesh against their
unsharded runs; ``default_x0``; and a two-process gloo run (two ranks, each
owning 2 of B = 4 scenarios, in ``test_torch_mp_worker.py``) that agrees
bitwise between its ranks and within 1e-10 with a one-process run and with
the JAX package's ``run_batch``."""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.solver import sqp as jsqp
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.eval import metrics
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.nn import fnn, lstm, train
from forging_control_tpu_torch.parallel import launcher, mesh as pmesh
import test_torch_mp_worker as worker


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group on the CPU, for the file's tests."""
    launcher.initialize(num_processes=1)           # one process: a no-op
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{_free_port()}", world_size=1, rank=0)
    yield pmesh.make_mesh(device="cpu")
    dist.destroy_process_group()


def test_torch_mesh_helpers_one_rank(mesh1):
    assert (mesh1.size, mesh1.rank, mesh1.axis) == (1, 0, "scenario")
    assert mesh1.device == torch.device("cpu")
    assert launcher.global_scenario_mesh(device="cpu") == mesh1
    assert pmesh.default_mesh(device="cpu") is None       # one rank
    x = np.arange(16.0).reshape(16, 1)
    tree = {"x": x, "pair": (torch.ones(4, 2), None)}
    got = pmesh.shard_scenarios(mesh1, tree)
    np.testing.assert_array_equal(got["x"].numpy(), x)
    assert got["pair"][1] is None and got["pair"][0].shape == (4, 2)
    rep = pmesh.replicate(mesh1, {"w": x})
    np.testing.assert_array_equal(rep["w"].numpy(), x)
    arr = launcher.host_local_batch_to_global(mesh1, x)
    np.testing.assert_array_equal(arr.numpy(), x)
    mean = pmesh.all_mean({"a": torch.tensor(3.0), "b": [torch.ones(2)]},
                          mesh1)
    assert float(mean["a"]) == 3.0 and mean["b"][0].tolist() == [1.0, 1.0]


def test_torch_sharded_closed_loop_matches_one_process(mesh1):
    """The sharded loop with process noise from a generator equals
    ``run_batch`` with a generator in the same state, bitwise."""
    x0_all, refs_all = worker.batch()
    ctrl = worker.controllers()["sqp"]
    loop_cfg = worker.loop_configs()["noisy"]
    x0_s, refs_s = pmesh.shard_scenarios(mesh1, (x0_all, refs_all))
    _, telem_s = pmesh.sharded_closed_loop(loop_cfg, ctrl, mesh1)(
        x0_s, refs_s, torch.Generator().manual_seed(3))
    _, telem = cl.run_batch(loop_cfg, ctrl, x0_all, refs_all,
                            torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(telem_s.u, telem.u) and torch.equal(telem_s.w,
                                                           telem.w)
    assert float(telem.w.abs().max()) > 0


def test_torch_sharded_metrics_match_local(mesh1):
    rng = np.random.RandomState(0)
    ref = torch.from_numpy(rng.randn(16, 30))
    y_dot = ref + 0.1 * torch.from_numpy(rng.randn(16, 30))
    ref_s, y_s = pmesh.shard_scenarios(mesh1, (ref, y_dot))
    m = pmesh.sharded_metrics(mesh1)(ref_s, y_s)
    want = metrics.tracking_metrics(ref, y_dot)
    for k in ("MAE", "RMSE", "R2"):
        np.testing.assert_allclose(float(m[k]), float(want[k]), rtol=1e-9)


def _l1(params, batch):
    return train.l1_loss(fnn.apply(params, batch[0]), batch[1])


def test_torch_data_parallel_update_matches_jax_full_batch_step(mesh1):
    """One step on the one-rank mesh equals the JAX package's full-batch
    ``optax.adamw(1e-3)`` step from the same weights."""
    jparams, _ = jfnn.init(jax.random.PRNGKey(0), dtype=jnp.float64)
    rng = np.random.RandomState(0)
    x = rng.randn(64, 3)
    y = np.tanh(rng.randn(64, 1))

    def jloss(p, batch):
        xb, yb = batch
        return jnp.mean(jnp.abs(jfnn.apply(p, xb) - yb))

    tx = optax.adamw(1e-3)
    l_full, g_full = jax.value_and_grad(jloss)(jparams, (x, y))
    upd, _ = tx.update(g_full, tx.init(jparams), jparams)
    want = optax.apply_updates(jparams, upd)

    p = {k: v.requires_grad_(True) for k, v in interop.fnn_params_from_numpy(
        jax.tree.map(np.asarray, jparams), device="cpu").items()}
    step = pmesh.data_parallel_update(
        mesh1, _l1, torch.optim.AdamW(list(p.values()), lr=1e-3,
                                      weight_decay=1e-4))
    loss = step(p, pmesh.shard_scenarios(mesh1, (x, y)))
    np.testing.assert_allclose(float(loss), float(l_full), rtol=1e-9)
    for k in want:
        np.testing.assert_allclose(p[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=1e-8,
                                   atol=1e-10)


def test_torch_mesh_sharded_training_matches_unsharded(mesh1):
    """``train_supervised`` and ``train_surrogate`` with the mesh (the
    gradients all-reduced) against their runs without one; a batch that
    does not divide stays whole."""
    rng = np.random.default_rng(0)
    xt, yt = rng.uniform(-1, 1, (512, 3)), rng.uniform(-1, 1, (512, 1))
    xv, yv = rng.uniform(-1, 1, (128, 3)), rng.uniform(-1, 1, (128, 1))
    params = fnn.init(torch.Generator().manual_seed(0), dtype=torch.float64,
                      device="cpu")[0]
    p_ref, rep_ref = train.train_supervised(params, xt, yt, xv, yv, epochs=3,
                                            batch_size=64, seed=0)
    p_dp, rep_dp = train.train_supervised(params, xt, yt, xv, yv, epochs=3,
                                          batch_size=64, seed=0, mesh=mesh1)
    for k in p_ref:
        np.testing.assert_allclose(p_dp[k].numpy(), p_ref[k].numpy(),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(rep_dp.val_losses, rep_ref.val_losses,
                               rtol=1e-8)
    np.testing.assert_allclose(rep_dp.train_losses, rep_ref.train_losses,
                               rtol=1e-8)

    x = torch.from_numpy(rng.normal(size=(40, 4, 5)))
    y = torch.from_numpy(rng.normal(size=(40, 4)))
    runs = []
    for mesh in (None, mesh1):
        model = lstm.init(torch.Generator().manual_seed(1), hidden_dim=8,
                          num_layers=2, dtype=torch.float64, device="cpu")
        runs.append(train.train_surrogate(model, x, y, x, y, epochs=2,
                                          batch_size=16, mesh=mesh))
    for a, b in zip(runs[0][0].parameters(), runs[1][0].parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(runs[1][1].train_losses,
                               runs[0][1].train_losses, rtol=1e-8)


def test_torch_default_x0_matches_jax():
    np.testing.assert_array_equal(cl.default_x0(device="cpu").numpy(),
                                  np.asarray(jcl.default_x0()))
    assert cl.default_x0(torch.float32, device="cpu").dtype == torch.float32


def _jax_run(backend):
    cfg = jsqp.MPCConfig(horizon=5, variant="smooth", gn_iters=2, al_iters=1)
    x0, refs = worker.batch()
    loop_cfg = jcl.LoopConfig(t_steps=worker.T, variant="smooth")
    ctrl = jcl.MPCController(cfg, backend=backend)
    _, telem = jax.jit(lambda x, r, k: jcl.run_batch(loop_cfg, ctrl, x, r,
                                                     k))(
        jnp.asarray(x0), jnp.asarray(refs), jax.random.PRNGKey(0))
    return np.asarray(telem.u)


def test_torch_two_process_gloo_closed_loop(tmp_path):
    """Two processes, one gloo rank each, run the worker: the replicated
    results (metrics, the mean command, the data-parallel step and a
    ``train_supervised(mesh=...)`` run) agree bitwise between the ranks;
    the ranks' rows, concatenated, agree within 1e-10 with a one-process
    run of the port (the noisy run's noise drawn from the same generator)
    and with the JAX package's ``run_batch``; the training within 1e-10 of
    the one-process training."""
    port = _free_port()
    worker_py = os.path.join(os.path.dirname(__file__),
                             "test_torch_mp_worker.py")
    outs = [str(tmp_path / f"rank{i}.json") for i in range(2)]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, worker_py, str(i), "2", str(port), outs[i]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, text in zip(procs, logs):
        assert p.returncode == 0, text[-3000:]
    r0, r1 = [json.load(open(o)) for o in outs]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, 2)
    for name in ("sqp", "ilqr", "sqp_noisy"):
        for k in ("MAE", "RMSE", "R2", "u_mean"):
            assert r0[name][k] == r1[name][k], (name, k)
    assert r0["dp"] == r1["dp"] and r0["train"] == r1["train"]

    x0, refs = worker.batch()
    ctrls, loops = worker.controllers(), worker.loop_configs()
    for name, ctrl, loop_cfg in (("sqp", ctrls["sqp"], loops["clean"]),
                                 ("ilqr", ctrls["ilqr"], loops["clean"]),
                                 ("sqp_noisy", ctrls["sqp"],
                                  loops["noisy"])):
        _, telem = cl.run_batch(loop_cfg, ctrl, x0, refs,
                                torch.Generator().manual_seed(3),
                                device="cpu")
        u = np.concatenate([r0[name]["u"], r1[name]["u"]])
        np.testing.assert_array_equal(
            np.concatenate([r0[name]["w"], r1[name]["w"]]), telem.w.numpy())
        np.testing.assert_allclose(u, telem.u.numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=name)
        m = metrics.tracking_metrics(telem.ref, telem.x[..., 1])
        for k in ("MAE", "RMSE", "R2"):
            np.testing.assert_allclose(r0[name][k], float(m[k]), rtol=1e-10,
                                       err_msg=(name, k))
        if name != "sqp_noisy":
            np.testing.assert_allclose(u, _jax_run(name), rtol=1e-10,
                                       atol=1e-12, err_msg=name)

    x, y, params = worker.dp_data()
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    for v in p.values():            # AdamW decays the unused leaves too
        v.grad = torch.zeros_like(v)
    opt = torch.optim.AdamW(list(p.values()), lr=1e-3, weight_decay=1e-2)
    loss = _l1(p, (torch.from_numpy(x), torch.from_numpy(y)))
    loss.backward()
    opt.step()
    np.testing.assert_allclose(r0["dp"]["loss"], float(loss.detach()),
                               rtol=1e-10)
    for k, v in p.items():
        np.testing.assert_allclose(r0["dp"]["params"][k],
                                   v.detach().numpy(), rtol=1e-10,
                                   atol=1e-12, err_msg=k)
    trained, rep = train.train_supervised(params, x, y, x, y, epochs=2,
                                          batch_size=4)
    np.testing.assert_allclose(r0["train"]["losses"], rep.train_losses,
                               rtol=1e-10)
    for k, v in trained.items():
        np.testing.assert_allclose(r0["train"]["params"][k], v.numpy(),
                                   rtol=1e-10, atol=1e-12, err_msg=k)
