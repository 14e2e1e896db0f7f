"""The port's bench entry: preset resolution and the one-line record, at a
tiny size on the CPU (its numbers there are not device numbers)."""

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
    json.dumps(rec)
    with pytest.raises(ValueError, match="card"):
        bench.profile_run(5, 3, 1, "fast_5x1", "sqp", device="cpu")


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
