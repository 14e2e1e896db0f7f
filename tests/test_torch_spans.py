"""The program's spans (``utils.profiling.annotate`` and ``spans``) and
the benchmark's readers of them.

With no profiler running, a hot-path span (``stepper``,
``stepper.inputs``) does nothing and a set-up span (``period.first``,
``period.eager``, ``graph.capture``, ``graph.instantiate``,
``kernels.build``) is only kept.  Under ``torch.profiler`` every span is a
``record_function`` range, stamped on the clock of the operations it
encloses.

This file imports neither jax nor the JAX package; its one test that needs
a card (``gpu``) runs there without the conftest:

    python -m pytest -p no:cacheprovider --noconftest -q tests/test_torch_spans.py
"""

import collections
import functools
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.loop import graph
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
F64 = torch.float64
STEPS = 3


@pytest.fixture
def kept(monkeypatch):
    """An empty list of kept spans for the test."""
    monkeypatch.setattr(profiling, "_kept", collections.deque(
        maxlen=profiling.SPANS_KEPT))


def _controller():
    """A cheap controller of the loop's interface: a fixed feedback on
    the measured speed, as tensor code."""
    return cl.FunctionController(
        lambda x, ref, u_prev: 0.5 * (ref - x[:, 1]) + 0.1 * u_prev)


def _cpu_stepper():
    return cl.make_stepper(cl.LoopConfig(variant="smooth"), _controller(),
                           dtype=F64, device="cpu")


def _graph_stepper():
    """The card's stepper on the CPU, its capture left out by the
    caller."""
    loop_cfg = cl.LoopConfig(variant="smooth")
    ctrl = _controller()
    x0 = torch.tensor(press.X0_REFERENCE, dtype=F64).reshape(1, 5)
    carry0 = cl.StepperCarry(
        x0, press.measure(x0, loop_cfg.params, loop_cfg.variant),
        ctrl.init_carry_batch(1, F64, "cpu"), torch.zeros(1, dtype=F64))

    def noise(std, given, what):
        if given is None:
            return torch.zeros(1, 5, dtype=F64)
        return torch.as_tensor(given, dtype=F64).reshape(1, 5)

    return cl._GraphStepper(loop_cfg, ctrl, carry0, noise, F64,
                            torch.device("cpu")), carry0


def _periods(step, carry, n=STEPS):
    for t in range(n):
        carry, u = step(carry, 0.1 * (t + 1),
                        process_noise=[0.0, 1e-4, 0.0, 0.0, 0.0])
        float(u)
    return carry


def _traced_stepper_record():
    """``benchmark.trace.record`` of ``STEPS`` calls of the CPU stepper."""
    step, carry = _cpu_stepper()
    carry = _periods(step, carry, 1)
    return trace.record(lambda: _periods(step, carry))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_torch_annotate_without_a_profiler_does_nothing(monkeypatch, kept):
    """No profiler: no ``record_function`` is entered (it raises here), a
    hot-path span gives None and keeps nothing, steps of the stepper leave
    the kept list as it was, and a set-up span is kept with its parent."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.annotate("stepper") as rec:
        with profiling.annotate("stepper.inputs") as inner:
            pass
    assert rec is None and inner is None
    step, carry = _cpu_stepper()
    _periods(step, carry)
    assert profiling.spans() == []
    with profiling.annotate("period.first") as first:
        with profiling.annotate("kernels.build", "ilqr plant"):
            pass
    names = [(s["name"], s["parent"], s["args"]) for s in profiling.spans()]
    assert names == [("period.first", None, None),
                     ("kernels.build", "period.first", "ilqr plant")]
    assert first["start"] <= profiling.spans()[1]["start"] \
        <= profiling.spans()[1]["end"] <= first["end"]


@pytest.mark.parametrize("which", ["cpu", "graph"])
def test_torch_stepper_spans_enclose_their_ops_on_the_profilers_clock(
        which, monkeypatch, kept):
    """Under the profiler each stepper call leaves one ``stepper`` range
    with one ``stepper.inputs`` inside it, and every aten op that starts
    in a range ends in it: the ranges are on the operations' clock.  The
    card's stepper (capture left out) keeps its first call as
    ``period.first`` over ``period.eager``."""
    monkeypatch.setattr(graph.Period, "capture", lambda self: None)
    step, carry = _cpu_stepper() if which == "cpu" else _graph_stepper()
    carry = _periods(step, carry, 1)
    if which == "graph":
        assert [(s["name"], s["parent"]) for s in profiling.spans()] == [
            ("period.first", None), ("period.eager", "period.first")]
    rec = trace.record(lambda: _periods(step, carry))
    steppers = [h for h in rec["host"] if h[0] == "stepper"]
    inputs = [h for h in rec["host"] if h[0] == "stepper.inputs"]
    assert len(steppers) == len(inputs) == STEPS
    assert len(profiling.spans()) == (2 if which == "graph" else 0)
    aten = [h for h in rec["host"] if h[0].startswith("aten::")]
    for outer in steppers:
        assert sum(_inside(i, outer) for i in inputs) == 1
        mine = [a for a in aten if outer[1] <= a[1] <= outer[2]]
        assert mine and all(_inside(a, outer) for a in mine)
    for outer in inputs:
        mine = [a for a in aten if outer[1] <= a[1] <= outer[2]]
        assert mine and all(_inside(a, outer) for a in mine)


def test_torch_run_batch_keeps_its_first_period_within_the_bound(kept):
    """``run_batch`` on the CPU keeps one ``period.first`` with a
    ``period.eager`` child; the kept list never holds more than
    ``SPANS_KEPT``, the newest last."""
    ctrl = _controller()
    x0 = torch.tensor([press.X0_REFERENCE] * 2, dtype=F64)
    run = functools.partial(cl.run_batch, cl.LoopConfig(t_steps=3), ctrl, x0,
                            torch.full((2, 3), 0.3, dtype=F64), device="cpu")
    run()
    first, eager = profiling.spans()
    assert (first["name"], first["parent"]) == ("period.first", None)
    assert (eager["name"], eager["parent"]) == ("period.eager",
                                                "period.first")
    assert first["start"] <= eager["start"] <= eager["end"] <= first["end"]
    for _ in range(profiling.SPANS_KEPT):
        with profiling.annotate("graph.capture"):
            pass
    run()
    kept_now = profiling.spans()
    assert len(kept_now) == profiling.SPANS_KEPT
    assert [s["name"] for s in kept_now[-2:]] == ["period.first",
                                                  "period.eager"]


def test_torch_span_metrics_read_the_programs_spans(monkeypatch, kept):
    """The benchmark's readers on a traced record of the CPU stepper:
    ``stepper_host_us.realtime`` is the mean ``stepper`` range in us,
    ``solve_wait_us.realtime`` None (no K5 on the CPU); ``first_period_s``
    sums the kept ``period.first`` spans, and is None for a program that
    keeps no spans."""
    rec = _traced_stepper_record()
    host_us = harness.reader(ROOT, "stepper_host_us.realtime")(rec)
    lengths = [t1 - t0 for n, t0, t1 in rec["host"] if n == "stepper"]
    assert host_us > 0
    assert host_us == pytest.approx(1e6 * sum(lengths) / len(lengths))
    assert harness.reader(ROOT, "solve_wait_us.realtime")(rec) is None
    first_period_s = harness.reader(ROOT, "first_period_s")
    assert first_period_s(rec) is None
    cl.run_batch(cl.LoopConfig(t_steps=2), _controller(),
                 torch.tensor([press.X0_REFERENCE], dtype=F64),
                 torch.full((1, 2), 0.3, dtype=F64), device="cpu")
    (first,) = [s for s in profiling.spans() if s["name"] == "period.first"]
    assert first_period_s(rec) == first["end"] - first["start"] > 0
    monkeypatch.delattr(profiling, "spans")
    assert first_period_s(rec) is None


def test_torch_solve_wait_pairs_each_stepper_with_the_next_k5():
    """``solve_wait_us.realtime`` on a made-up record: each ``stepper``
    range waits until the first K5 launch inside it or before the next
    range; a range with no launch before the next one is left out."""
    k5 = "void ilqr_kernel<float>"
    rec = {"host": [("stepper", 1.0, 1.5), ("stepper", 2.0, 2.5),
                    ("stepper", 3.0, 3.5), ("aten::copy_", 1.1, 1.2)],
           "ops": [("plant_team_kernel", 1.05, 1.06), (k5, 1.3, 1.8),
                   (k5, 1.9, 1.95), (k5, 3.2, 3.9)]}
    wait = harness.reader(ROOT, "solve_wait_us.realtime")(rec)
    assert wait == pytest.approx(1e6 * (0.3 + 0.2) / 2)


@pytest.mark.gpu
def test_torch_capture_stats_are_its_spans(kept):
    """On a card, ``Period.capture``'s ``capture_s`` and
    ``instantiate_s`` are its kept ``graph.capture`` and
    ``graph.instantiate`` spans, the capture's end before the
    instantiation's start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: a CUDA graph has no CPU mode")
    state = torch.ones(8, device="cuda")
    period = graph.Period(lambda s, i: (s * 2 + i, s.sum()), state,
                          torch.zeros(8, device="cuda"))
    period()
    period.capture()
    cap, inst = profiling.spans()
    assert (cap["name"], inst["name"]) == ("graph.capture",
                                           "graph.instantiate")
    assert period.stats["capture_s"] == cap["end"] - cap["start"] > 0
    assert period.stats["instantiate_s"] == inst["end"] - inst["start"] > 0
    assert cap["end"] <= inst["start"]
