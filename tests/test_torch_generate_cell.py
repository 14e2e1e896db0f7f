"""The benchmark's dataset-generation deployment (``benchmark/configs/
ilqr_n25.json``, traffic ``generate``: the AL-iLQR at N = 25 with the
default 5 x 2 preset, mu0 = 1e2) on the CPU, and K5's sweep counter.

- K5's body (host build, float64) in a few periods of ``run_batch`` on the
  generator's references and noise from a seed, against the benchmark's
  plain reference (``benchmark/reference``).  At N = 25 the AL-iLQR turns
  rounding into other accepted steps, so no two implementations agree to
  1e-9 on every scenario: the port's own plain float64 path parts from the
  reference beyond 1e-9 on some.  The kernel is held to 1e-9 where the
  plain path is, and beyond that to the share rule of
  ``bench.kernel_check``: the share of scenarios beyond 1e-9 at most
  ``bench.SHARE_SLACK`` above the plain path's.
- The sweep counter (``ops.ilqr.kernel_sweeps``, the host library's count
  here) against the count that the recorded trace implies: in each AL
  round, every iteration up to the first that took no step (whose step
  norm is 0), the repeats after it skipped; rounds past
  ``ilqr.SWEEP_ROUNDS`` in the last.
- The cell end to end at a tiny size through ``benchmark.harness.run``,
  with K5's body routed in, on a program with the counter (the record
  holds it) and without (it holds none), and the two new metrics'
  readers.
"""

import functools
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_host_kernels as hk
from benchmark import harness, traffic as tr
from benchmark.drivers import program
from benchmark.reference import loop as ref_loop
from forging_control_tpu_torch import bench
from forging_control_tpu_torch.loop.closed_loop import run_batch
from forging_control_tpu_torch.ops import ilqr
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import riccati

ROOT = Path(__file__).resolve().parents[1]
CELL = "ilqr_n25-generate"
F64 = torch.float64
# Units of the states' gaps (benchmark/check.py): 0.1 m, 0.1 m/s, 10 MPa,
# 10 MPa, 0.01 m.
X_SCALE = torch.tensor([0.1, 0.1, 1e7, 1e7, 0.01], dtype=F64)


def _files():
    bench_json = harness.read_json(ROOT / "BENCHMARK.json")
    _, cfg, traffic, _ = harness.cell(ROOT, bench_json, CELL)
    return cfg, traffic


def test_torch_generate_config_is_the_ports_generate_deployment():
    """The configuration's solver is ``GenerateConfig``'s default preset
    (``MPCConfig()``) at its horizon, through the AL-iLQR that
    ``resolve_backend`` picks there; the traffic is the generator's."""
    from forging_control_tpu_torch.loop.closed_loop import resolve_backend
    from forging_control_tpu_torch.pipelines.config import (GenerateConfig,
                                                            PROCESS_STD)
    cfg, traffic = _files()
    gen = GenerateConfig()
    _, ctrl = program.objects(cfg)
    default = riccati.MPCConfig(horizon=gen.horizon)
    assert ctrl.cfg == default and gen.solver_preset == "default"
    assert resolve_backend("auto", gen.horizon) == cfg["backend"] == "ilqr"
    assert tuple(cfg["process_std"]) == PROCESS_STD
    assert cfg["x0"] == list(press.X0_REFERENCE)
    assert (cfg["t_steps"], traffic["batch"]) == (gen.t_traj, 4096)
    assert traffic["reference"] == {"variant": gen.ref_variant, "gain": 0.9,
                                    "offset": 0.0, "split": 0.5}


@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 40 + 7])
def test_torch_k5_host_at_n25_matches_benchmark_reference(monkeypatch, seed):
    cfg, traffic = _files()
    B, T = 8, 3
    cfg = dict(cfg, dtype="float64", t_steps=T)
    refs, noise = tr.draw(dict(traffic, batch=B), cfg, seed, 0, "cpu")
    x0 = tr.x0(cfg, B, "cpu")
    loop_cfg, ctrl = program.objects(cfg)
    run = functools.partial(run_batch, loop_cfg, ctrl, x0, refs,
                            process_noise=noise, device="cpu")
    _, plain = run()
    counts = hk.route_kernels_to_host(monkeypatch)
    _, kern = run()
    assert dict(counts) == {"plant": T, "ilqr": T}
    u_ref, x_ref = ref_loop.closed_loop(cfg, x0, refs, noise)
    for got in (kern, plain):
        assert torch.isfinite(got.u).all() and torch.isfinite(got.x).all()

    # 1e-9 on every scenario where the plain float64 path holds it; at
    # N = 25 the solve turns rounding into other accepted steps, on some
    # scenarios in any implementation, so beyond 1e-9 the share rule.
    def far(tel):
        # u (B, T) and the states in the check's units, (B, T, 5).
        return bench.far_share(
            torch.cat([tel.u[..., None], tel.x / X_SCALE], -1),
            torch.cat([u_ref[..., None], x_ref / X_SCALE], -1), 1e-9)
    assert far(kern) <= far(plain) + bench.SHARE_SLACK, (far(kern),
                                                         far(plain))


def _trace_sweeps(trace, gn, al):
    """Per round, the iterations computed, from the trace (B, al * gn, 6):
    every iteration up to the first whose step norm (column 3) is 0."""
    stalled = (trace[..., 3] == 0).reshape(-1, al, gn)
    first = torch.where(stalled.any(-1), stalled.int().argmax(-1) + 1,
                        torch.full(stalled.shape[:2], gn))
    per_round = first.sum(0).tolist()
    out = per_round[:ilqr.SWEEP_ROUNDS]
    out += [0] * (ilqr.SWEEP_ROUNDS - len(out))
    out[-1] += sum(per_round[ilqr.SWEEP_ROUNDS:])
    return out


@pytest.mark.parametrize("N, gn, al", [(25, 5, 2), (5, 5, 2), (4, 2, 10)])
def test_torch_k5_sweep_counter_is_the_traces_count(N, gn, al):
    cfg = riccati.MPCConfig(horizon=N, gn_iters=gn, al_iters=al,
                            record_trace=True)
    B = 16
    rng = np.random.RandomState(N + 100 * al)
    x0, ref, up = hk.float64(np.tile(press.X0_REFERENCE, (B, 1)),
                             rng.uniform(-0.9, 0.9, B),
                             rng.uniform(-0.05, 0.05, B))
    v, lam = torch.zeros(B, N, dtype=F64), torch.zeros(B, N, 2, dtype=F64)
    hk.sweeps_host(reset=True)
    out = hk.solve_host(cfg, x0, ref, up, v, lam)
    got = hk.sweeps_host(reset=True)
    want = _trace_sweeps(out.trace, gn, al)
    assert got == want
    # Some repeats were skipped, and each round computed at least one
    # iteration of every scenario.
    assert B * min(al, ilqr.SWEEP_ROUNDS) <= sum(got) < B * gn * al
    assert hk.sweeps_host() == [0] * ilqr.SWEEP_ROUNDS


def _reader(name):
    return harness.reader(ROOT, name)


@pytest.mark.parametrize("counted", [True, False])
def test_torch_generate_metrics_read_the_counter_and_the_trace(counted):
    cfg, _ = _files()
    rec = {"cfg": cfg, "batch": 4096, "periods": 40, "ops": [],
           "window_s": 1.0}
    if counted:
        rec["k5_sweeps"] = [40 * 4096 * 5, 40 * 4096 * 2] + [0] * 6
        rec["ops"] = [("void ilqr_kernel<float, 8>", 0.0, 0.025),
                      ("void ilqr_kernel<float, 8>", 0.03, 0.05)]
    sweeps = _reader("k5_sweeps.generate")(rec)
    roof = _reader("k5_roofline.generate")(rec)
    if not counted:
        assert sweeps is None and roof is None
        return
    assert sweeps == 7.0
    from benchmark.work import k5, peaks
    work = k5.count(cfg, 4096)
    least = peaks.least_time(work["ops"], work["bytes"], "float32")
    assert roof == pytest.approx(100.0 * least / 0.0225)
    assert roof == _reader("k5_roofline.datagen")(rec)


def tiny(cfg, traffic):
    """The cell at a size the CPU runs in seconds."""
    cfg["t_steps"] = 4
    traffic["batch"] = 4
    traffic["check"]["rows"] = 4


@pytest.mark.parametrize("counter", [True, False])
def test_torch_generate_cell_end_to_end_on_the_cpu(monkeypatch, counter):
    """K5's and K4's bodies routed in; without the counter (``False``: as
    on a program that has none) the record holds no count and the metric
    reads None."""
    # This process holds JAX through tests/conftest.py, which a run refuses
    # (benchmark/tests checks the refusal); the program here holds none.
    monkeypatch.setattr(harness, "forbidden", lambda: [])
    counts = hk.route_kernels_to_host(monkeypatch)
    if not counter:
        monkeypatch.delattr(ilqr, "kernel_sweeps")
    out = harness.run(CELL, 2 ** 33 + 5, 0.0, True, time.perf_counter(),
                      device="cpu", patch=tiny)
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0 and out["attempted"] == 4 * 4
    # warm-up, one call of the window, the traced call: 4 periods each
    assert counts["ilqr"] == 12
    # No device trace on the CPU: nothing for the roofline to read.
    assert "k5_roofline.generate" not in out["metrics"]
    sweeps = out["metrics"].get("k5_sweeps.generate", {}).get("value")
    if counter:
        assert 2 <= sweeps <= 10      # a round computes 1 to 5 iterations
    else:
        assert sweeps is None
