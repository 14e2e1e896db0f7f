"""One control period over static buffers, captured as a CUDA graph.

The port's counterpart of the JAX package's compiled closed loop: the
``lax.scan`` body of ``_run_batch_fused``, compiled once, and
``make_stepper``'s ahead-of-time program with a donated carry
(``forging_control_tpu/loop/closed_loop.py:236-351``).  Eagerly, a period
is 10^5-10^6 kernels, each dispatched from Python; captured, it is one
graph launch.

A :class:`Period` holds the loop's state and its per-period inputs in
static buffers and runs ``body(state, inputs) -> (new_state, outputs)`` on
them: the new state is copied back into the static state, and the outputs
are left in tensors that the next call overwrites.  :meth:`Period.capture`
captures that body with ``torch.cuda.graph`` on a side stream; every later
call replays it.  Uncaptured (the CPU), every call runs the body eagerly:
the same ops on the same buffers, which is how the CPU tests hold the
captured period against the eager loop.

:func:`run` drives ``steps`` periods.  Its first period runs eagerly on
plain tensors laid out as the static buffers will be: it is a real period,
it tells whether autograd records through the body (then the run stays
eager), and it is the capture's warm-up (kernels loaded, cuBLAS handles
made, a policy's weight copies cached).  Then the body is captured from the
state it left, and the other periods replay.  Given a captured period (a
cache's), every period replays.  That first period and its capture are
the kept span ``period.first``, its eager period ``period.eager``
(``utils.profiling``).

The body must create no tensor from host data, read no scalar back and
call nothing that synchronises (``dual.constants`` and fill ops make its
constants); a capture that meets such an op raises, and nothing falls back
to the eager loop.

Launch counts: ``ops.build.launch`` counts the kernels' launches in
``ops.build.LAUNCHES`` as the body dispatches them.  A capture's counts are
taken back, and each replay adds them again, so the counter reads the same
after a captured run as after an eager one.

A :class:`Step` is the same machinery for one training step, the
counterpart of the JAX package's jitted training programs: forward,
backward and optimizer update over static buffers of the parameters, the
optimizer's state and the step's inputs, captured whole after a first,
eager step.
"""

from __future__ import annotations

import gc

import torch

from ..ops import build
from ..utils.profiling import annotate

# One side stream per device for every capture (a CUDA graph is captured
# on a stream other than the default one): cuBLAS keeps a workspace per
# stream, which is then made once.
_STREAMS: dict = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device)
    return _STREAMS[device]


def tree_map(fn, tree):
    """``fn`` over the tensor leaves of nested tuples, lists, dicts and
    NamedTuples (None leaves stay None)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, t) for t in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def copy_into(dst, src) -> None:
    """``dst_leaf.copy_(src_leaf)`` for every leaf (shapes must match)."""
    for d, s in zip(leaves(dst), leaves(src), strict=True):
        d.copy_(s)


def records(tree) -> bool:
    """Whether autograd records through a tree of tensors."""
    return torch.is_grad_enabled() and any(a.requires_grad
                                           for a in leaves(tree))


def _static(tree):
    return tree_map(lambda a: a.detach().clone(
        memory_format=torch.contiguous_format), tree)


class Period:
    """``body`` over static copies of ``state`` and ``inputs`` (trees of
    tensors on one device).

    ``state`` and ``inputs`` are the static buffers: write a period's
    inputs into ``inputs`` (:func:`copy_into`) before a call, read the
    state after it.  ``stats`` holds, once captured, the seconds spent
    dispatching the body into the capture (``capture_s``), ending the
    capture and instantiating the graph (``instantiate_s``), both read from
    the kept spans ``graph.capture`` and ``graph.instantiate``
    (``utils.profiling.spans``), the device
    memory reserved while capturing, the graph's private pool
    (``pool_bytes``), and the kernel launches of one replay by kernel name
    (``launches``, as ``ops.build.LAUNCHES`` counts them)."""

    def __init__(self, body, state, inputs):
        self.body = body
        self.state = _static(state)
        self.inputs = _static(inputs)
        self.device = leaves(self.state)[0].device
        self.graph = None
        self.outputs = None
        self.stats: dict = {}
        self._delta: dict = {}

    def _run(self):
        new_state, outputs = self.body(self.state, self.inputs)
        copy_into(self.state, new_state)
        return outputs

    def __call__(self):
        """One period: the outputs, in tensors that the next call may
        overwrite."""
        if self.graph is None:
            return self._run()
        self.graph.replay()
        for name, n in self._delta.items():
            build.LAUNCHES[name] += n
        return self.outputs

    def capture(self) -> None:
        """Capture the body as a CUDA graph (after a warm-up: an eager
        period with inputs laid out as the static buffers).  Raises where
        the body cannot be captured."""
        if self.device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got "
                             f"{self.device}")
        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        before = build.LAUNCHES.copy()
        graph = torch.cuda.CUDAGraph()
        # A graph that the garbage collector frees during a capture makes
        # a CUDA call that invalidates the capture: collect first, and not
        # while capturing.
        gc.collect()
        gc.disable()
        instantiating = annotate("graph.instantiate")
        try:
            with torch.cuda.graph(graph, stream=side):
                with annotate("graph.capture") as capture:
                    reserved = torch.cuda.memory_reserved(self.device)
                    outputs = self._run()
                instantiate = instantiating.__enter__()
        finally:
            instantiating.__exit__(None, None, None)
            gc.enable()
        self._delta = dict(build.LAUNCHES - before)
        build.LAUNCHES.subtract(self._delta)
        self.graph, self.outputs = graph, outputs
        self.stats = {
            "capture_s": capture["end"] - capture["start"],
            "instantiate_s": instantiate["end"] - instantiate["start"],
            "pool_bytes": torch.cuda.memory_reserved(self.device) - reserved,
            "launches": dict(self._delta)}


def resolve(graph: bool | None, device) -> bool:
    """Whether a run on ``device`` captures: ``None`` on a card only,
    ``True`` always (and then it needs a card), ``False`` never."""
    device = torch.device(device)
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}")
    return device.type == "cuda" if graph is None else bool(graph)


class Step(Period):
    """One training step, ``body(state, inputs) -> (new_state, outputs)``:
    ``state`` holds the parameters and the optimizer's state, ``inputs``
    the step's batch (an index row, noise or reference draws), ``outputs``
    the loss.  The body takes its gradients with ``torch.autograd.grad``
    from the parameters it is given (so no ``.grad`` accumulates across
    replays) and computes the new state without autograd.

    ``graph=False`` (the eager reference): every call runs the body on the
    current ``state``, which the new state then replaces; nothing is
    copied.  ``graph=True``: the state and the inputs live in static
    buffers (the inputs' made at the first call); the first call runs the
    body eagerly on the buffers (a real step, and the capture's warm-up)
    and then captures it; every later call copies its inputs in and
    replays.  Either way ``state`` is the current state: read it, or copy a
    snapshot into it (:func:`copy_into`) to rewind.  The outputs are
    tensors of their own.
    """

    def __init__(self, body, state, *, graph: bool):
        super().__init__(body, state, None)
        self.captures = graph

    def __call__(self, inputs):
        if not self.captures:
            self.state, outputs = self.body(self.state, inputs)
            return outputs
        if self.inputs is None:
            self.inputs = _static(inputs)
        else:
            copy_into(self.inputs, inputs)
        if self.graph is None:
            outputs = self._run()
            self.capture()
            return outputs
        return tree_map(torch.clone, super().__call__())


def run(body, state, inputs, steps: int, *, graph, period=None):
    """``steps`` periods of ``body`` from ``state``; ``inputs(t)`` gives
    period t's inputs (a tree of tensors).

    ``graph``: False runs every period eagerly; True captures the body
    after the first period and replays it for the others, and raises if
    autograd records through the body; None does the same, except that a
    recording body stays eager.  ``period``: a captured :class:`Period` of
    the same body and shapes, whose replays then run every period from
    ``state`` (unless autograd records through ``state`` or the inputs).

    Returns ``(state after the last period, [outputs of each period],
    the captured Period or None)``; the outputs and the returned state are
    tensors of their own, not the static buffers."""
    first = inputs(0)
    if period is not None and records((state, first)):
        if graph:
            raise RuntimeError("autograd records through this run's "
                               "inputs: a captured period cannot carry "
                               "their gradient; run with graph=False")
        period = None
    outs = []
    if period is None:
        with annotate("period.first"):
            if graph is not False:
                state, first = tree_map(lambda a: a.contiguous(),
                                        (state, first))
            with annotate("period.eager"):
                state, out = body(state, first)
            outs.append(out)
            if graph is not False and records((state, out)):
                if graph:
                    raise RuntimeError("autograd records through the "
                                       "period: it cannot be captured; run "
                                       "with graph=False")
            elif graph is not False:
                period = Period(body, state, first)
                period.capture()
        if period is None:
            for t in range(1, steps):
                state, out = body(state, inputs(t))
                outs.append(out)
            return state, outs, None
    else:
        copy_into(period.state, state)
        copy_into(period.inputs, first)
        outs.append(tree_map(torch.clone, period()))
    for t in range(1, steps):
        copy_into(period.inputs, inputs(t))
        outs.append(tree_map(torch.clone, period()))
    return tree_map(torch.clone, period.state), outs, period
