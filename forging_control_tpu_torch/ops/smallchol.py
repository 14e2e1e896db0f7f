"""Batched small-SPD Cholesky solves — the SQP's damped normal solves.

Port of ``forging_control_tpu/ops/smallchol.py``.  Three functions:

* :func:`chol_solve_torch` — the plain version: the Cholesky recurrence
  unrolled over the (small, static) N, every line an elementwise op over
  the leading axes.  It is the kernel's reference, the CPU path, and what
  ``solver.sqp.polish`` calls (as the JAX package calls its jnp solve
  there).
* :func:`chol_solve_cuda` — the wrapper of the hand-written CUDA kernel
  ``csrc/smallchol.cu`` (the counterpart of ``chol_solve_pallas``).  It
  checks its inputs, allocates the output and launches on the current
  stream (``build.launch``, which counts it under ``"smallchol"``).
* :func:`chol_solve` — dispatch on the tensor's device: a CPU tensor takes
  the plain version, a CUDA tensor the kernel, anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_N = 25


def _chol_factor_rows(H):
    """Unrolled Cholesky of H (..., N, N) -> list of rows of L."""
    N = H.shape[-1]
    L = [[None] * N for _ in range(N)]
    for j in range(N):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, N):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def chol_solve_torch(H, g):
    """Solve H x = g for SPD H (..., N, N), g (..., N); elementwise over the
    leading axes.  O(N^3/3) elementwise ops, unrolled over N."""
    N = H.shape[-1]
    L = _chol_factor_rows(H)
    y = [None] * N
    for i in range(N):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * N
    for i in reversed(range(N)):
        s = y[i]
        for k in range(i + 1, N):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


_SYMBOLS = {torch.float32: "fct_chol_solve_f32",
            torch.float64: "fct_chol_solve_f64"}
_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)


def chol_solve_cuda(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Hand-written CUDA kernel: solve H x = g for H (B, N, N), g (B, N).

    H and g must be contiguous CUDA tensors of one dtype (float32 or
    float64) on one device, with 1 <= N <= 25, and must not require a
    gradient (the kernel has no backward, like ``chol_solve_pallas``).
    """
    if H.device.type != "cuda" or g.device != H.device:
        raise ValueError(f"chol_solve_cuda needs CUDA tensors on one device, "
                         f"got {H.device} and {g.device}")
    if H.dtype not in _SYMBOLS or g.dtype != H.dtype:
        raise TypeError(f"chol_solve_cuda takes float32 or float64, got "
                        f"{H.dtype} and {g.dtype}")
    if H.dim() != 3 or H.shape[1] != H.shape[2] or g.shape != H.shape[:2]:
        raise ValueError(f"chol_solve_cuda takes H (B, N, N) and g (B, N), "
                         f"got {tuple(H.shape)} and {tuple(g.shape)}")
    B, N = g.shape
    if not 1 <= N <= MAX_N:
        raise ValueError(f"chol_solve_cuda supports 1 <= N <= {MAX_N}, "
                         f"got N={N}")
    if not (H.is_contiguous() and g.is_contiguous()):
        raise ValueError("chol_solve_cuda takes contiguous H and g")
    if H.requires_grad or g.requires_grad:
        raise RuntimeError("chol_solve_cuda has no backward; pass tensors "
                           "that do not require a gradient")
    fn = build.entry("smallchol", _SYMBOLS[H.dtype], _ARGTYPES)
    x = torch.empty_like(g)
    build.launch("smallchol", fn, H.device, H.data_ptr(), g.data_ptr(),
                 x.data_ptr(), B, N)
    return x


def chol_solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for H (..., N, N), g (..., N) on the tensors' device:
    the plain version on the CPU, the CUDA kernel on a card."""
    if H.device.type == "cpu":
        return chol_solve_torch(H, g)
    if H.device.type != "cuda":
        raise ValueError(f"chol_solve: unsupported device {H.device}")
    N = H.shape[-1]
    lead = g.shape[:-1]
    x = chol_solve_cuda(H.reshape(-1, N, N).contiguous(),
                        g.reshape(-1, N).contiguous())
    return x.reshape(*lead, N)
