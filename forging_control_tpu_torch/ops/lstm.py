"""Stacked-LSTM surrogate forward over a whole window — kernel B2.

Port of ``forging_control_tpu/ops/lstm_pallas.py``.  Three functions:

* :func:`lstm_forward_torch` — the plain version: the recurrence of the JAX
  package's ``nn/lstm._cell`` as eager tensor ops, torch gate order
  (i, f, g, o), bias-free cells, zero initial (h, c), readout of the last
  timestep.  It is the kernel's reference, the CPU path, and the
  differentiable forward that training runs (``nn.lstm.LSTMSurrogate``).
* :func:`lstm_forward_cuda` — the wrapper of the hand-written CUDA kernel
  ``csrc/lstm.cu`` (the counterpart of ``apply_pallas``).  It checks its
  inputs, picks the kernel's variant with :func:`variant` (by shape and
  dtype alone: the tensor-core 3xTF32 ``"mma"`` kernel for float32 at
  H <= 64 when its block fits in shared memory, the general ``"simt"``
  kernel otherwise), allocates the output and launches on the current
  stream (``build.launch``, which counts it under ``"lstm mma"`` or
  ``"lstm simt"``).  Forward only, like
  ``apply_pallas``: it refuses inputs that require a gradient.
* :func:`lstm_forward` — dispatch on the input's device: a CPU tensor takes
  the plain version, a CUDA tensor the kernel, anything else raises.

Weights keep the JAX package's layout: ``w_ih[l]`` (I_l, 4H) with I_0 = I
and I_l = H above, ``w_hh[l]`` (H, 4H), ``w_out`` (H, O), ``b_out`` (O,) or
None.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

MAX_HIDDEN = 256      # simt: 4H gate columns, one thread each, <= 1024
MAX_LAYERS = 16
ROWS = 8              # simt: batch rows per block (kRows in csrc/lstm.cu)
MMA_ROWS = 32         # mma: batch rows per block (kMmaRows)
MMA_MAX_HIDDEN = 64   # mma: 8 hidden units per warp, at most 8 warps
MAX_SMEM = 232448     # bytes of shared memory a block can use on Hopper


def lstm_forward_torch(x, w_ih, w_hh, w_out, b_out=None):
    """(..., T, I) windows -> (..., O) readout of the last timestep."""
    H = w_hh[0].shape[0]
    lead = x.shape[:-2]
    h = [x.new_zeros(*lead, H) for _ in w_hh]
    c = [x.new_zeros(*lead, H) for _ in w_hh]
    for t in range(x.shape[-2]):
        inp = x[..., t, :]
        for l, (wi, wh) in enumerate(zip(w_ih, w_hh)):
            gates = inp @ wi + h[l] @ wh
            i, f, g, o = gates.split(H, dim=-1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            inp = h[l]
    out = h[-1] @ w_out
    if b_out is not None:
        out = out + b_out
    return out


_SYMBOLS = {("mma", torch.float32): "fct_lstm_forward_mma_f32",
            ("simt", torch.float32): "fct_lstm_forward_f32",
            ("simt", torch.float64): "fct_lstm_forward_f64"}
_ARGTYPES = ((ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
              ctypes.POINTER(ctypes.c_void_p)) + (ctypes.c_void_p,) * 3
             + (ctypes.c_int,) * 6 + (ctypes.c_void_p,))


def smem_bytes(I: int, H: int, L: int, dtype) -> int:
    """Shared memory of one block of the simt variant: h and c per layer,
    the gate pre-activations and the input row of ``ROWS`` batch rows."""
    item = torch.finfo(dtype).bits // 8
    return item * ROWS * (2 * L * H + 4 * H + I)


def smem_bytes_mma(T: int, I: int, H: int) -> int:
    """Shared memory of one block of the mma variant (``mma_smem_bytes`` in
    csrc/lstm.cu): one layer's weights in fragment order, K and the gate
    columns padded to multiples of 8, plus the h sequence ``[T]`` and h
    double buffer ``[2]`` of ``MMA_ROWS`` rows at a row stride of
    max(K) + 4 floats."""
    ki, h8 = -(-I // 8) * 8, -(-H // 8) * 8
    kmax = max(ki, h8)
    w_floats = (kmax + h8) // 8 * (4 * h8 // 8) * 64
    return 4 * (w_floats + (T + 2) * MMA_ROWS * (kmax + 4))


def variant(dtype, T: int, I: int, H: int) -> str:
    """Which kernel takes a call, by shape and dtype alone: ``"mma"`` (the
    tensor-core 3xTF32 kernel) for float32 with H <= 64 whose block fits in
    shared memory, ``"simt"`` (the general kernel) for everything else."""
    if (dtype == torch.float32 and H <= MMA_MAX_HIDDEN
            and smem_bytes_mma(T, I, H) <= MAX_SMEM):
        return "mma"
    return "simt"


def _check(x, w_ih, w_hh, w_out, b_out):
    tensors = [x, *w_ih, *w_hh, w_out] + ([] if b_out is None else [b_out])
    if any(t.requires_grad for t in tensors):
        raise RuntimeError("lstm_forward_cuda has no backward; pass tensors "
                           "that do not require a gradient")
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("lstm_forward_cuda needs CUDA tensors on one device, "
                         f"got {sorted({str(t.device) for t in tensors})}")
    if (x.dtype not in (torch.float32, torch.float64)
            or any(t.dtype != x.dtype for t in tensors)):
        raise TypeError("lstm_forward_cuda takes float32 or float64 tensors "
                        f"of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tensors})}")
    if x.dim() != 3:
        raise ValueError(f"lstm_forward_cuda takes x (B, T, I), got "
                         f"{tuple(x.shape)}")
    B, T, I = x.shape
    L = len(w_hh)
    if not (1 <= L <= MAX_LAYERS and len(w_ih) == L):
        raise ValueError(f"lstm_forward_cuda supports 1 to {MAX_LAYERS} "
                         f"layers, got {len(w_ih)} w_ih and {L} w_hh")
    H = w_hh[0].shape[0]
    O = w_out.shape[-1]
    if not 1 <= H <= MAX_HIDDEN:
        raise ValueError(f"lstm_forward_cuda supports 1 <= H <= {MAX_HIDDEN},"
                         f" got H={H}")
    want = [(I if l == 0 else H, 4 * H) for l in range(L)]
    if ([tuple(w.shape) for w in w_ih] != want
            or any(tuple(w.shape) != (H, 4 * H) for w in w_hh)
            or tuple(w_out.shape) != (H, O)
            or (b_out is not None and tuple(b_out.shape) != (O,))):
        raise ValueError(
            f"lstm_forward_cuda: weight shapes do not fit x {tuple(x.shape)} "
            f"and H={H}: w_ih {[tuple(w.shape) for w in w_ih]}, w_hh "
            f"{[tuple(w.shape) for w in w_hh]}, w_out {tuple(w_out.shape)}, "
            f"b_out {None if b_out is None else tuple(b_out.shape)}")
    if T < 1:
        raise ValueError("lstm_forward_cuda needs T >= 1 timesteps")
    kind = variant(x.dtype, T, I, H)
    if kind == "simt" and smem_bytes(I, H, L, x.dtype) > MAX_SMEM:
        raise ValueError(f"lstm_forward_cuda: I={I}, H={H}, L={L} need "
                         f"{smem_bytes(I, H, L, x.dtype)} B of shared memory,"
                         f" more than a block's {MAX_SMEM}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("lstm_forward_cuda takes contiguous tensors")
    return kind, (B, T, I, H, L, O)


def lstm_forward_cuda(x: torch.Tensor, w_ih, w_hh, w_out: torch.Tensor,
                      b_out: torch.Tensor | None = None) -> torch.Tensor:
    """Hand-written CUDA kernel: x (B, T, I) -> (B, O).

    Every tensor must be a contiguous CUDA tensor of one dtype (float32 or
    float64) on one device, with 1 <= H <= 256 and 1 <= L <= 16, and none may
    require a gradient.
    """
    kind, shape = _check(x, w_ih, w_hh, w_out, b_out)
    B, L, O = shape[0], shape[4], shape[5]
    fn = build.entry("lstm", _SYMBOLS[kind, x.dtype], _ARGTYPES)
    out = x.new_empty(B, O)
    ptrs = ctypes.c_void_p * L
    build.launch("lstm " + kind, fn, x.device, x.data_ptr(),
                 ptrs(*(w.data_ptr() for w in w_ih)),
                 ptrs(*(w.data_ptr() for w in w_hh)), w_out.data_ptr(),
                 None if b_out is None else b_out.data_ptr(), out.data_ptr(),
                 *shape)
    return out


def lstm_forward(x: torch.Tensor, w_ih, w_hh, w_out: torch.Tensor,
                 b_out: torch.Tensor | None = None) -> torch.Tensor:
    """(..., T, I) -> (..., O) on the input's device: the plain version on
    the CPU, the CUDA kernel on a card."""
    if x.device.type == "cpu":
        return lstm_forward_torch(x, w_ih, w_hh, w_out, b_out)
    if x.device.type != "cuda":
        raise ValueError(f"lstm_forward: unsupported device {x.device}")
    T, I = x.shape[-2:]
    out = lstm_forward_cuda(x.reshape(-1, T, I).contiguous(), list(w_ih),
                            list(w_hh), w_out, b_out)
    return out.reshape(*x.shape[:-2], out.shape[-1])
