"""Profiling hooks and the program's spans.

Port of ``forging_control_tpu/utils/profiling.py``.  The reference brackets
every controller step with ``do_mpc.tools.Timer`` and stores IPOPT's
wall-time phases (SURVEY.md section 5).  Here:

* :func:`trace` captures a ``torch.profiler`` trace of a block and writes
  it to ``log_dir`` (Chrome/Perfetto JSON, TensorBoard's layout);
* :func:`annotate` is the program's span: a named region of a trace, and
  for a set-up span a record that :func:`spans` returns;
* :func:`solver_phase_breakdown` times the condensed GN-SQP solve's NLP
  phases one by one over a scenario batch.

A span costs what its use needs.  With no profiler session running, a span
of the hot path (a control period's) is a set lookup and a flag check, and
nothing more.
While a ``torch.profiler`` session runs, every span is a
``record_function`` range, which the profiler stamps on the clock of the
device's operations, so a trace shows it beside the kernels.  The set-up
spans (:data:`SETUP_SPANS`: a first period, a capture, a kernel build; a
handful a process) are also always kept, with their start and end on
``time.perf_counter`` and the name of the kept span they lie in, in a list
of at most :data:`SPANS_KEPT`, oldest dropped first.  Spans are those of
one thread: the parent is the innermost kept span open at the start.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

# The spans that mark set-up, kept whether or not a profiler runs:
#   period.first       a new graph key's first period, from the eager start
#                      to the end of the graph's instantiation
#   period.eager       its eager period
#   graph.capture      Period.capture's dispatch of the body into the capture
#   graph.instantiate  the end of the capture and the graph's instantiation
#   kernels.build      ops.build.build_all's compile and load (args: the
#                      sources)
SETUP_SPANS = frozenset({"period.first", "period.eager", "graph.capture",
                         "graph.instantiate", "kernels.build"})
SPANS_KEPT = 256
_kept: collections.deque = collections.deque(maxlen=SPANS_KEPT)
_open: list = []            # the kept spans open now, innermost last
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Capture a profiler trace of the block (host ops, and the card's
    kernels when there is one), written to ``log_dir`` when the block
    ends."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


class _Span:
    """A span that does something: a profiler range while a session runs,
    and for a set-up span a kept record, which ``with`` gives (else
    None)."""

    __slots__ = ("name", "args", "keep", "record", "_range")

    def __init__(self, name: str, args: str | None, keep: bool):
        self.name, self.args, self.keep = name, args, keep
        self.record = self._range = None

    def __enter__(self):
        if self.keep:
            self.record = {"name": self.name, "start": time.perf_counter(),
                           "end": None,
                           "parent": _open[-1]["name"] if _open else None,
                           "args": self.args}
            _kept.append(self.record)
            _open.append(self.record)
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name, self.args)
            self._range.__enter__()
        return self.record

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        if self.record is not None:
            self.record["end"] = time.perf_counter()
            _open.remove(self.record)
        return False


def annotate(name: str, args: str | None = None):
    """The span ``name`` around a block (``with annotate(name): ...``).
    With no profiler session running, a span not in :data:`SETUP_SPANS`
    does nothing; otherwise it is a ``record_function`` range (``args`` its
    arguments) while a session runs, and a set-up span is kept
    (:func:`spans`).  ``with`` gives the kept record, whose ``start`` and
    ``end`` are set when the block is entered and left, or None."""
    keep = name in SETUP_SPANS
    if keep or _profiler._is_profiler_enabled:
        return _Span(name, args, keep)
    return _OFF


def spans() -> list[dict]:
    """Copies of the kept set-up spans, oldest first: ``{"name", "start",
    "end", "parent", "args"}``, times in seconds on ``time.perf_counter``
    (``end`` None while open), ``parent`` the name of the kept span it lies
    in or None."""
    return [dict(s) for s in _kept]


def _op_counter():
    """A dispatch mode that counts the aten ops dispatched under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            return func(*args, **(kwargs or {}))

    return OpCounter()


def _seconds(fn, device) -> float:
    """Wall seconds of one call of ``fn``: between two CUDA events on a
    card, synchronised on both ends; by ``perf_counter`` on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize(device)
    return t0.elapsed_time(t1) / 1e3


def solver_phase_breakdown(cfg, batch: int = 256, reps: int = 3, dtype=None,
                           generator: torch.Generator | None = None,
                           device="cuda") -> dict:
    """Per-phase cost of the condensed GN-SQP solve, the counterpart of the
    reference's ``t_wall_nlp_{f,g,grad_f,jac_g}`` IPOPT phase timers
    (``Supervised Learning/Functions.py:848-853``).  Each NLP phase is one
    eager call over a scenario batch of ``batch``, timed alone:

      f         objective evaluation (rollout + tracking/rterm cost)
      g         constraint evaluation (rollout + scaled pressure bounds)
      grad_f    objective gradient (reverse mode, torch autograd)
      jac_g     constraint Jacobian (forward mode, ``dual.linearize``)
      linsolve  the J^T J + 1e-6 I normal-equations solve (N x N) through
                ``ops.smallchol.chol_solve``: kernel B1 on a card
      total     one production ``solve_batch`` (B1 gn_iters x al_iters
                times on a card)

    Each phase runs once as a warm-up, under a dispatch mode that counts
    its aten ops (``ops``: on a card, the launches that set its host time;
    B1's launch goes through ctypes and is not an aten op), then ``reps``
    times; ``t_wall_s`` is the best.  ``chol_solve_launches`` counts the
    launches of kernel B1 over a phase's 1 + ``reps`` calls.  The inputs
    (a perturbed ``X0_REFERENCE``, references in [-0.9, 0.9], v ~ 0.05 N(0,
    1), u_prev = 0) are drawn from ``generator`` (default: seeded with 0).
    Returns a JSON-ready dict with the JAX package's keys, ``ops`` and
    ``chol_solve_launches`` in place of XLA's static cost fields.
    """
    from .. import dual as ad
    from ..device import resolve_device
    from ..ops import build
    from ..ops.smallchol import chol_solve
    from ..physics import press
    from ..solver import sqp

    device = resolve_device(device)
    dtype = dtype or torch.float32
    gen = generator if generator is not None \
        else torch.Generator().manual_seed(0)
    N = cfg.horizon
    f64 = torch.float64
    x0 = torch.tensor(press.X0_REFERENCE, dtype=f64).repeat(batch, 1)
    x0 = x0 * (1.0 + 0.01 * torch.randn(x0.shape, generator=gen, dtype=f64))
    ref = torch.empty(batch, dtype=f64).uniform_(-0.9, 0.9, generator=gen)
    v = 0.05 * torch.randn(batch, N, generator=gen, dtype=f64)
    x0, ref, v = (a.to(device, dtype) for a in (x0, ref, v))
    u_prev = torch.zeros(batch, dtype=dtype, device=device)

    def obj(vv):
        r, _ = sqp._obj_res_con(cfg, x0, ref, u_prev, vv)
        return torch.sum(r * r, dim=-1)

    def con(vv):
        return sqp._constraints(cfg, sqp._rollout(cfg, x0, vv))

    def grad_f():
        vv = v.detach().requires_grad_(True)
        with torch.enable_grad():
            return torch.autograd.grad(obj(vv).sum(), vv)[0]

    def jac_g():
        return ad.linearize(con, v)[1]                 # (B, n_con, N)

    with torch.no_grad():
        J = jac_g()
        H = (torch.einsum("bci,bcj->bij", J, J)
             + 1e-6 * torch.eye(N, dtype=dtype, device=device)).contiguous()
        g_rhs = torch.einsum("bci,bc->bi", J, con(v)).contiguous()
    state = sqp.init_state(cfg, dtype, device)
    state = type(state)(*(a.expand(batch, *a.shape) for a in state))

    phases = {
        "f": lambda: obj(v),
        "g": lambda: con(v),
        "grad_f": grad_f,
        "jac_g": jac_g,
        "linsolve": lambda: chol_solve(H, g_rhs),
        "total": lambda: sqp.solve_batch(cfg, x0, ref, u_prev, state)[0],
    }
    out = {"horizon": N, "batch": batch, "backend": device.type,
           "phases": {}}
    for name, fn in phases.items():
        with torch.no_grad():
            launches0 = build.LAUNCHES["smallchol"]
            counter = _op_counter()
            with counter:
                fn()                                    # warm-up
            best = min(_seconds(fn, device) for _ in range(reps))
        out["phases"][name] = {
            "t_wall_s": best,
            "t_wall_per_solve_us": best / batch * 1e6,
            "ops": counter.ops,
            "chol_solve_launches": build.LAUNCHES["smallchol"] - launches0,
        }
    total = out["phases"]["total"]["t_wall_s"]
    for rec in out["phases"].values():
        rec["fraction_of_total"] = rec["t_wall_s"] / total if total else None
    return out
