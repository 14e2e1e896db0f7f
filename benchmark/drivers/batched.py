"""Driver of the batched cells: the closed loop over a batch of scenarios,
one ``run_batch`` call a trajectory batch, calls back to back.

Each call takes B scenarios through the configuration's ``t_steps``
periods: references and process noise drawn from the seed for that call
(``benchmark/traffic.py``), every scenario from the configuration's
initial state, a cold controller.  The call ends when its telemetry is on
the device (a synchronisation), as a dataset generator's call ends before
it stores the telemetry.  ``solves_per_s`` is every scenario-period of the
calls that the window ran, over the window's whole time.

The set-up draws its own inputs and makes one call of the cell's shape:
the program's first period runs eagerly, its period is captured as a CUDA
graph and cached; every call of the window replays it.
"""

from __future__ import annotations

import math
import time

import torch

from .. import traffic as tr
from . import program


class Cell:
    def __init__(self, cfg, traffic, seed, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans = device, spans
        self.B, self.T = traffic["batch"], cfg["t_steps"]
        self.loop_cfg, self.ctrl = program.objects(cfg)
        self.kept = []           # per call: (index, u (S, T), x (S, T, 5))
        self.bad = None          # non-finite commands, on the device
        self.calls = 0
        self.period_s = None

    def _call(self, index, t_steps=None, keep=False):
        refs, noise = tr.draw(self.traffic, self.cfg, self.seed, index,
                              self.device)
        if t_steps is not None:
            refs, noise = refs[:, :t_steps], noise[:, :t_steps]
        with self.spans("run_batch"):
            _, tel = program.run_batch(
                self.cfg, self.loop_cfg, self.ctrl,
                tr.x0(self.cfg, self.B, self.device), refs, noise,
                self.device)
            self.sync()
        if keep:
            rows = torch.as_tensor(self.rows(index), device=self.device)
            self.kept.append((index, tel.u[rows], tel.x[rows]))
            bad = (~torch.isfinite(tel.u)).sum()
            self.bad = bad if self.bad is None else self.bad + bad
        return tel

    def rows(self, index):
        """The scenarios of call ``index`` that the check compares."""
        g = torch.Generator().manual_seed(
            tr.unit_seed(self.seed, index, stream=1))
        n = min(self.B, self.traffic["check"]["rows"])
        return torch.randperm(self.B, generator=g)[:n].tolist()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self):
        with self.spans("warmup"):
            self._call(tr.WARMUP)

    def window(self, seconds):
        t0 = time.perf_counter()
        while True:
            self._call(self.calls, keep=True)
            self.calls += 1
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        self.period_s = elapsed / (self.calls * self.T)
        return {"solves_per_s": self.calls * self.B * self.T / elapsed}

    def attempted_failed(self):
        return self.calls * self.B * self.T, int(self.bad)

    def traced(self, trace_seconds):
        """One traced call of as many periods as last ``trace_seconds``
        untraced (at least one, at most a trajectory)."""
        from .. import trace
        n = max(1, min(self.T, math.ceil(trace_seconds / self.period_s)))
        self.spans.profiling = True
        try:
            rec = trace.record(lambda: self._call(tr.TRACED, t_steps=n))
        finally:
            self.spans.profiling = False
        rec.update(periods=n, batch=self.B)
        return rec

    def streams(self):
        """The compared streams: per kept call, its sampled scenarios."""
        rows = []
        for index, u, x in self.kept:
            refs, noise = tr.draw(self.traffic, self.cfg, self.seed, index,
                                  self.device, rows=self.rows(index))
            for i in range(u.shape[0]):
                rows.append({"x0": self.cfg["x0"], "refs": refs[i].cpu(),
                             "noise": noise[i].cpu(), "u": u[i].cpu(),
                             "x": x[i].cpu()})
        return rows
