"""Profiling hooks.

Port of ``forging_control_tpu/utils/profiling.py``.  The reference brackets
every controller step with ``do_mpc.tools.Timer`` and stores IPOPT's
wall-time phases (SURVEY.md section 5).  Here:

* :func:`trace` captures a ``torch.profiler`` trace of a block and writes
  it to ``log_dir`` (Chrome/Perfetto JSON, TensorBoard's layout);
* :func:`annotate` names a region in such a trace
  (``torch.profiler.record_function``);
* :func:`solver_phase_breakdown` times the condensed GN-SQP solve's NLP
  phases one by one over a scenario batch.
"""

from __future__ import annotations

import contextlib
import time

import torch


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


def annotate(name: str):
    """Named region (shows up in traces)."""
    return torch.profiler.record_function(name)


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
    from ..ops.smallchol import chol_solve, chol_solve_cuda
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
            launches0 = chol_solve_cuda.launches
            counter = _op_counter()
            with counter:
                fn()                                    # warm-up
            best = min(_seconds(fn, device) for _ in range(reps))
        out["phases"][name] = {
            "t_wall_s": best,
            "t_wall_per_solve_us": best / batch * 1e6,
            "ops": counter.ops,
            "chol_solve_launches": chol_solve_cuda.launches - launches0,
        }
    total = out["phases"]["total"]["t_wall_s"]
    for rec in out["phases"].values():
        rec["fraction_of_total"] = rec["t_wall_s"] / total if total else None
    return out
