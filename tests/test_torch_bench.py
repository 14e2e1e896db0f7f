"""The port's bench entry: preset resolution, the one-line record and the
kernel check before timing, at a tiny size on the CPU (its numbers there
are not device numbers)."""

import json
from pathlib import Path

import pytest

from forging_control_tpu_torch import bench

REPO = Path(__file__).resolve().parents[1]


def test_torch_bench_preset_default_reads_parity_artifact():
    parity = json.loads((REPO / "docs" / "RESULTS-parity.json").read_text())
    preset, quality = bench._preset_default(10)
    assert preset == parity["fast_preset_ab"]["preset"] == "fast_5x1"
    assert "fast_preset_ab" in quality
    cfg = bench.PRESETS[preset](horizon=10, variant="smooth")
    assert (cfg.gn_iters, cfg.al_iters, cfg.mu0) == (5, 1, 1e4)


def test_torch_run_bench_record_on_cpu():
    rec = bench.run_bench(5, 3, 1, 1, "fast_5x1", "sqp", device="cpu")
    assert rec["metric"] == "closed-loop MPC solves/s/CPU run (N=5, batch=3)"
    assert rec["value"] > 0 and rec["steps"] == 1
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    # On the CPU every dispatcher takes the plain version: no launch.
    none = {"chol_solve": 0, "ilqr": 0, "plant": 0, "sqp_build": 0,
            "sqp_search": 0}
    assert rec["kernels"] == ["sqp_build", "chol_solve", "sqp_search",
                              "plant"]
    assert rec["kernel_launches"] == none
    assert rec["backend"] == "sqp" and rec["linsolve"] == "kernel"
    # The check ran first: on the CPU both paths take the plain versions.
    assert rec["kernel_check"] == {"batch": 64, "steps": 1, "backend": "sqp",
                                   "max_abs_du": 0.0, "tolerance": 1e-4,
                                   "kernel_launches": none}
    json.dumps(rec)
    rec = bench.run_bench(5, 3, 1, 1, "fast_5x1", "ilqr", device="cpu")
    assert rec["kernels"] == ["ilqr", "plant"]
    assert rec["kernel_check"]["backend"] == "ilqr"
    assert rec["kernel_check"]["max_abs_du"] == 0.0
    with pytest.raises(ValueError, match="card"):
        bench.profile_run(5, 3, 1, "fast_5x1", "sqp", device="cpu")


def test_torch_run_bench_refuses_to_time_a_wrong_kernel(monkeypatch):
    """``run_bench`` through the kernels refuses to time when the kernel
    path is off: here the solve that the SQP's ``linsolve="kernel"``
    dispatches to is perturbed by 10 %, which moves the B = 64 step's
    commands past 1e-4; nothing is timed.  The same for the AL-iLQR's
    kernel path (its solve's commands perturbed); through the plain
    versions (``linsolve="plain"``) nothing is checked."""
    from forging_control_tpu_torch.ops import smallchol
    from forging_control_tpu_torch.solver import riccati, sqp

    monkeypatch.setattr(sqp, "chol_solve", lambda H, g: 1.1 * smallchol
                        .chol_solve_torch(H, g))
    timed = []
    monkeypatch.setattr(bench, "_runner", lambda *a: timed.append(a))
    with pytest.raises(RuntimeError, match="kernel check failed"):
        bench.run_bench(5, 3, 1, 1, "fast_5x1", "sqp", device="cpu")
    assert timed == []
    with pytest.raises(RuntimeError, match="kernel check failed"):
        bench.kernel_check(5, "fast_5x1", device="cpu")
    monkeypatch.undo()
    solve = riccati._solve_batch_plain

    def off(*a):
        u, st, d = solve(*a)
        return 1.1 * u, st, d

    monkeypatch.setattr(riccati, "solve_batch", lambda *a, solver="kernel":
                        (off if solver == "kernel" else solve)(*a))
    monkeypatch.setattr(bench, "_runner", lambda *a: timed.append(a))
    with pytest.raises(RuntimeError, match="ilqr kernel and plain"):
        bench.run_bench(5, 3, 1, 1, "fast_5x1", "ilqr", device="cpu")
    assert timed == []
    monkeypatch.undo()
    rec = bench.run_bench(5, 3, 1, 1, "fast_5x1", "ilqr", device="cpu",
                          linsolve="plain")
    assert rec["kernel_check"] is None


def test_torch_device_busy_unions_kernel_intervals():
    """device_busy reads the trace's raw events: the union of the CUDA
    kernels' intervals over the untraced wall time; host events do not
    count."""
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(kind, t0_us, t1_us, name):
        return SimpleNamespace(device_type=lambda: kind,
                               start_ns=lambda: t0_us * 1000,
                               end_ns=lambda: t1_us * 1000,
                               name=lambda: name)

    events = [event(DeviceType.CUDA, 0, 10, "a"),
              event(DeviceType.CUDA, 5, 20, "b"),      # overlaps a
              event(DeviceType.CUDA, 30, 40, "a"),
              event(DeviceType.CPU, 0, 100, "cudaLaunchKernel")]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    rec = bench.device_busy(prof, wall_s=1e-4)
    assert rec["kernels"] == 3
    assert abs(rec["device_busy_s"] - 30e-6) < 1e-12
    assert abs(rec["device_busy_share"] - 0.3) < 1e-9
    assert rec["top_kernels"][0]["name"] == "a"
    assert rec["top_kernels"][0]["count"] == 2


def test_torch_bench_far_share_counts_scenarios():
    """The AL-iLQR check's float64 rule counts scenarios (the leading axis)
    that part by more than the tolerance anywhere."""
    import torch

    a = torch.zeros(4, 3)
    b = a.clone()
    b[1, 2], b[3, 0], b[3, 1] = 2e-4, -5e-4, 1e-3
    b[2, 0] = 5e-5
    assert bench.far_share(a, b, 1e-4) == 0.5
    assert bench.far_share(a[:, 0], b[:, 0], 1e-4) == 0.25
    assert bench.far_share(a, a, 0.0) == 0.0
