"""The port's native runtime loader (no jax): its copy of the C++ sources is
the JAX package's, byte for byte; it builds into ``build/native_runtime``;
native ``rhs``, ``rk4``, the FNN policy and a native episode match the
port's physics, ``fnn`` and closed loop (float64); ``native_mpc_latency``
returns finite arrays (the port of ``tests/test_runtime.py:34-107``)."""

import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch

from forging_control_tpu_torch import interop, runtime
from forging_control_tpu_torch.integrate.rk4 import rk4_step
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.nn import fnn, scalers
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import sqp

REPO = Path(__file__).resolve().parents[1]
JAX_SRC = REPO / "forging_control_tpu" / "runtime" / "src"

STATES = [
    np.array(press.X0_REFERENCE),
    np.array([0.05, 0.5, 7.5e6, 5.3e6, 0.17]),
    np.array([0.08, -0.3, 1.2e7, 2.9e7, -0.12]),
    np.array([0.1, -0.6, -2.0e6, 3.5e7, -0.05]),
]


def test_torch_runtime_sources_are_the_jax_packages():
    names = sorted(p.name for p in runtime.SOURCE_DIR.iterdir())
    assert names == sorted(p.name for p in JAX_SRC.iterdir())
    assert "executor.cpp" in names
    _, mismatch, errors = filecmp.cmpfiles(runtime.SOURCE_DIR, JAX_SRC, names,
                                           shallow=False)
    assert mismatch == [] and errors == []


def test_torch_runtime_builds_into_build_dir():
    path = runtime.build()
    assert path.parent == REPO / "build" / "native_runtime"
    assert path.exists() and path == runtime.library_path()
    assert not any(p.suffix == ".so" for p in runtime.SOURCE_DIR.iterdir())
    with pytest.raises(ValueError, match="horizon"):
        runtime.NativeMPC(horizon=26)


def test_torch_runtime_missing_compiler_raises(monkeypatch):
    monkeypatch.setattr(runtime.shutil, "which", lambda name: None)
    with pytest.raises(runtime.NativeBuildError, match="g\\+\\+"):
        runtime.build(force=True)


@pytest.mark.parametrize("variant", ["raw", "smooth", "clamp"])
def test_torch_native_rhs_matches_port(variant):
    for x in STATES:
        for u in (0.0, 0.05, -0.15):
            want = press.rhs(torch.from_numpy(x), torch.tensor(u,
                                                               dtype=torch.float64),
                             variant=variant).numpy()
            np.testing.assert_allclose(runtime.rhs(x, u, variant), want,
                                       rtol=1e-10, atol=1e-8)


def test_torch_native_rk4_matches_port():
    def f(x, u):
        return press.rhs(x, u, variant="smooth")
    for x in STATES[:2]:
        want = rk4_step(f, torch.from_numpy(x),
                        torch.tensor(0.03, dtype=torch.float64), 1e-3,
                        4).numpy()
        np.testing.assert_allclose(runtime.rk4(x, 0.03, 1e-3, 4, "smooth"),
                                   want, rtol=1e-10, atol=1e-8)


def _policy():
    params, _ = fnn.init(torch.Generator().manual_seed(0),
                         dtype=torch.float64, device="cpu")
    in_sc = scalers.Scaler(torch.zeros(3, dtype=torch.float64),
                           torch.tensor([0.9, 0.2, 0.9],
                                        dtype=torch.float64))
    out_sc = scalers.Scaler(torch.zeros(1, dtype=torch.float64),
                            torch.tensor([0.2], dtype=torch.float64))
    return params, in_sc, out_sc


def test_torch_native_policy_matches_port():
    params, in_sc, out_sc = _policy()
    ex = runtime.RealtimeExecutor()
    ex.load_fnn_policy(params, in_sc, out_sc)
    policy = fnn.make_policy(params, in_sc, out_sc)
    rng = np.random.RandomState(0)
    for _ in range(20):
        x = rng.randn(5) * [0.05, 0.4, 1e7, 1e7, 0.1]
        ref = rng.uniform(-0.9, 0.9)
        want = policy(torch.from_numpy(x)[None],
                      torch.tensor([ref], dtype=torch.float64), None).item()
        ex._lib.fc_reset(ex._h, runtime._dp(np.ascontiguousarray(x)))
        lat = np.zeros(1, np.int64)
        got = ex._lib.fc_step(ex._h, ref, None, None, lat.ctypes.data_as(
            runtime.ctypes.POINTER(runtime.ctypes.c_int64)))
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    # numpy params (the JAX package's layout) load the same way
    ex.load_fnn_policy(interop.fnn_params_to_numpy(params), in_sc, out_sc)


def test_torch_native_episode_matches_port_loop():
    """The native executor and the port's closed loop give the same
    trajectory for the same policy (no noise, float64)."""
    params, in_sc, out_sc = _policy()
    ex = runtime.RealtimeExecutor()
    ex.load_fnn_policy(params, in_sc, out_sc)
    refs = np.concatenate([np.full(30, 0.4), np.full(30, -0.4)])
    xs, us, lat = ex.run_episode(np.array(press.X0_REFERENCE), refs)
    assert np.all(np.isfinite(xs)) and np.all(lat > 0)
    ctrl = cl.FunctionController(fnn.make_policy(params, in_sc, out_sc))
    _, telem = cl.run_batch(cl.LoopConfig(t_steps=60, variant="smooth"), ctrl,
                            np.array(press.X0_REFERENCE)[None], refs[None],
                            device="cpu")
    np.testing.assert_allclose(us, telem.u[0].numpy(), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(xs, telem.x[0].numpy(), rtol=1e-6, atol=1e-6)


def test_torch_native_mpc_latency_finite():
    """The native GN-SQP timed step by step against the port's float64
    plant with process noise: finite arrays of T, T and T - 1 entries, the
    run repeatable for a seed; the batch generator and its store."""
    loop_cfg = cl.LoopConfig(t_steps=6, variant="smooth",
                             process_std=(5e-1, 2e0, 5e7, 5e7, 2e0))
    cfg = sqp.MPCConfig(horizon=10, gn_iters=6, al_iters=2, p_max=32e6)
    refs = torch.full((6,), 0.3)
    xs, us, times = cl.native_mpc_latency(loop_cfg, cfg, refs, seed=3)
    assert xs.shape == (6, 5) and us.shape == (6,) and times.shape == (5,)
    assert np.all(np.isfinite(xs)) and np.all(np.isfinite(us))
    assert np.all(times > 0)
    xs2, us2, _ = cl.native_mpc_latency(loop_cfg, cfg, refs, seed=3)
    np.testing.assert_array_equal(us, us2)
    # Noise free, against the native episode runner, whose plant is the
    # native RK4: two float64 plants, so the bound of the native-vs-loop
    # state check above (1e-6), not bitwise.
    quiet = cl.LoopConfig(t_steps=6, variant="smooth")
    _, us_q, _ = cl.native_mpc_latency(quiet, sqp.MPCConfig(horizon=10),
                                       refs)
    _, us_e, _ = runtime.NativeMPC(horizon=10).run_episode(
        np.array(press.X0_REFERENCE), np.full(6, 0.3))
    np.testing.assert_allclose(us_q, us_e, rtol=1e-6, atol=1e-9)


def test_torch_native_batch_store(tmp_path):
    refs = np.tile(np.r_[np.full(5, 0.3), np.full(5, -0.3)], (3, 1))
    store = str(tmp_path / "traj.fcts")
    xs, us = runtime.mpc_generate_batch(np.array(press.X0_REFERENCE), refs,
                                        store_path=store)
    assert xs.shape == (3, 10, 5) and np.all(np.isfinite(us))
    ts = runtime.TrajStore(store)
    assert (ts.n_traj, ts.t_steps) == (3, 10)
    np.testing.assert_array_equal(ts.column("u"), us)
