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
    # On the CPU the dispatcher takes the plain solve: no kernel launch.
    assert rec["chol_kernel_launches"] == 0
    assert rec["backend"] == "sqp" and rec["linsolve"] == "kernel"
    # The check ran first: on the CPU both paths take the plain solve.
    assert rec["kernel_check"] == {"batch": 64, "steps": 1, "max_abs_du": 0.0,
                                   "tolerance": 1e-4,
                                   "chol_kernel_launches": 0}
    json.dumps(rec)
    with pytest.raises(ValueError, match="card"):
        bench.profile_run(5, 3, 1, "fast_5x1", "sqp", device="cpu")


def test_torch_run_bench_refuses_to_time_a_wrong_kernel(monkeypatch):
    """``run_bench`` on the SQP's kernel solve refuses to time when the
    kernel path's solve is off: here the solve that ``linsolve="kernel"``
    dispatches to is perturbed by 10 %, which moves the B = 64 step's
    commands past 1e-4; nothing is timed.  The iLQR backend has no kernel
    and skips the check."""
    from forging_control_tpu_torch.ops import smallchol
    from forging_control_tpu_torch.solver import sqp

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
    rec = bench.run_bench(5, 3, 1, 1, "fast_5x1", "ilqr", device="cpu")
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
