"""A run with the timed path broken underneath comes out not correct, for
each fault that the cells can have: a step that returns its state
unchanged, half of the batch left out (its commands the mean of the
other half's), an answer altered where it is produced, in every period or
only on the return stroke.  The runs skip the look for a card and run the
port's plain paths on the CPU at a tiny size; the comparison and its
limits are the cells' own."""

import time

import pytest
import torch
from forging_control_tpu_torch.loop.closed_loop import MPCController
from forging_control_tpu_torch.ops import plant

from benchmark import harness

from .test_bench_harness import tiny


def _stalled_plant(monkeypatch):
    real = plant.plant_step

    def step(cfg, x_true, x_meas, u, w, v):
        _, _, fd = real(cfg, x_true, x_meas, u, w, v)
        return x_true, x_meas, fd
    monkeypatch.setattr(plant, "plant_step", step)


def _half_batch(monkeypatch):
    real = MPCController.step_batch

    def step_batch(self, carry, x_meas, ref, u_prev):
        u, carry, diag = real(self, carry, x_meas, ref, u_prev)
        h = u.shape[0] // 2
        u = torch.cat([u[:h], u[:h].mean().expand(u.shape[0] - h)])
        return u, carry, diag
    monkeypatch.setattr(MPCController, "step_batch", step_batch)


def _altered(monkeypatch):
    real = MPCController.step_batch

    def step_batch(self, carry, x_meas, ref, u_prev):
        u, carry, diag = real(self, carry, x_meas, ref, u_prev)
        return u + 0.01, carry, diag
    monkeypatch.setattr(MPCController, "step_batch", step_batch)


def _return_stroke(monkeypatch):
    real = MPCController.step_batch

    def step_batch(self, carry, x_meas, ref, u_prev):
        u, carry, diag = real(self, carry, x_meas, ref, u_prev)
        return u + 0.01 * (ref < 0), carry, diag
    monkeypatch.setattr(MPCController, "step_batch", step_batch)


FAULTS = {"state unchanged": _stalled_plant, "half batch": _half_batch,
          "answer altered": _altered, "return stroke altered": _return_stroke}
CASES = [("ilqr_n10-datagen", f) for f in FAULTS] \
    + [("sqp_n10-datagen", f) for f in FAULTS] \
    + [("ilqr_n10-realtime", f) for f in ("state unchanged",
                                          "answer altered",
                                          "return stroke altered")]


def _run(name):
    seconds = 4.0 if "realtime" in name else 0.0     # 3 periods or more
    return harness.run(name, 2 ** 32 + 9, seconds, False, time.perf_counter(),
                       device="cpu", patch=tiny)


@pytest.mark.parametrize("name,fault", CASES)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = _run(name)
    assert out["correct"] is False
    assert any(v["value"] is not None and v["value"] > v["limit"]
               for v in out["checked"].values()), out["checked"]
