"""forging_control_tpu_torch: the PyTorch/CUDA port of forging_control_tpu.

The batched closed-loop MPC engine (press physics, RK4 plant, reference
streams, condensed GN-SQP and AL-iLQR solvers) and the LSTM plant-surrogate
chain (datasets, scalers, training, rollouts, the ``surrogate`` pipeline
and CLI) on an NVIDIA GPU, with the JAX package's Pallas kernels rewritten
as hand-written CUDA kernels (``csrc/smallchol.cu``, ``csrc/lstm.cu``, and
the toolchain probe ``csrc/probe.cu``).  The package imports torch and
never jax, and nothing of ``forging_control_tpu``.  Entry points run on
``"cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.2.0"

from . import physics, integrate, refgen, ops, solver, loop  # noqa: F401
