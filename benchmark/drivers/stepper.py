"""Driver of the single-stream cells: one press under the deployment's
real-time controller, ``make_stepper`` at B = 1, in a closed loop.

A period hands the stepper its reference and its process noise as host
values, the way a press's measurement and set point arrive, and ends when
the command has been read back to the host (``float(u)``, which waits for
the device).  The period's latency is the host clock around the two; the
end-to-end metrics are the median and the 95th percentile over every
period of the window.  Whole trajectories of the configuration's
``t_steps`` periods follow each other until the window's time has passed,
each with its own plateaus and noise from the seed; a trajectory starts
from the configuration's initial state and a cold controller, which the
harness writes into the stepper's carry (on a card the carry is the
captured period's own buffers, so nothing is captured again).

The set-up makes the stepper and runs ``WARMUP_PERIODS`` periods of its own
inputs: the first runs eagerly and captures the period as a CUDA graph,
the others replay it.
"""

from __future__ import annotations

import random
import statistics
import time

import torch

from .. import check, traffic as tr
from . import program

WARMUP_PERIODS = 3


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for t in tree for leaf in _leaves(t)]


class Cell:
    def __init__(self, cfg, traffic, seed, device, spans):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.spans = device, spans
        self.T = cfg["t_steps"]
        self.loop_cfg, self.ctrl = program.objects(cfg)
        self.times = []          # seconds of each period of the window
        self.trajs = []          # per trajectory: (index, [u, ...])
        self.bad = 0

    def _inputs(self, index):
        refs, noise = tr.draw(self.traffic, self.cfg, self.seed, index,
                              "cpu")
        return refs[0].tolist(), noise[0].numpy()

    def _start(self):
        """The carry back at the trajectory's start."""
        for dst, src in zip(_leaves(self.carry), self.first, strict=True):
            dst.copy_(src)

    def _periods(self, index, n, keep=None):
        """``n`` periods of trajectory ``index`` from its start; the
        commands go to ``keep``."""
        refs, noise = self._inputs(index)
        self._start()
        step, clock = self.step, time.perf_counter
        for t in range(n):
            t1 = clock()
            self.carry, u = step(self.carry, refs[t], process_noise=noise[t])
            t2 = clock()
            u = float(u)
            t3 = clock()
            if keep is not None:
                keep.append(u)
                self.times.append(t3 - t1)
                top = self.spans.add("period", t1, t3)
                self.spans.add("stepper", t1, t2, top)
                self.spans.add("read_back", t2, t3, top)
                if u != u or abs(u) == float("inf"):
                    self.bad += 1

    def setup(self):
        with self.spans("warmup"):
            self.step, self.carry = program.stepper(
                self.cfg, self.loop_cfg, self.ctrl, self.device)
            self.first = [a.clone() for a in _leaves(self.carry)]
            self._periods(tr.WARMUP, WARMUP_PERIODS)

    def window(self, seconds):
        """Whole trajectories until ``seconds`` have passed, so that every
        run holds each part of a trajectory in the same proportion."""
        deadline = time.perf_counter() + seconds
        while time.perf_counter() < deadline or not self.times:
            us = []
            self.trajs.append((len(self.trajs), us))
            with self.spans("trajectory"):
                self._periods(len(self.trajs) - 1, self.T, us)
        ms = sorted(1e3 * s for s in self.times)
        q = statistics.quantiles(ms, n=100, method="inclusive")
        self.period_s = sum(self.times) / len(self.times)
        return {"step_ms_p50": statistics.median(ms), "step_ms_p95": q[94]}

    def attempted_failed(self):
        return len(self.times), self.bad

    def traced(self, trace_seconds):
        """Traced periods of a trajectory, as many as last
        ``trace_seconds`` untraced (at most a trajectory)."""
        from .. import trace
        n = max(1, min(self.T, round(trace_seconds / self.period_s)))

        def periods():
            self._periods(tr.TRACED, n)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self.spans.profiling = True
        try:
            rec = trace.record(periods)
        finally:
            self.spans.profiling = False
        rec.update(periods=n, batch=1)
        return rec

    def streams(self):
        """The compared streams: up to ``rows`` of the window's
        trajectories that ran every compared period, drawn from the
        seed."""
        K = check.periods(self.traffic, self.T)
        ok = [(j, us) for j, us in self.trajs if len(us) >= K]
        rng = random.Random(tr.unit_seed(self.seed, 0, stream=1))
        picks = rng.sample(ok, min(len(ok), self.traffic["check"]["rows"]))
        rows = []
        for j, us in picks:
            refs, noise = tr.draw(self.traffic, self.cfg, self.seed, j,
                                  "cpu")
            rows.append({"x0": self.cfg["x0"], "refs": refs[0],
                         "noise": noise[0], "u": torch.tensor(us)})
        return rows
