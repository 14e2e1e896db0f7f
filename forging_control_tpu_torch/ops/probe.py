"""Kernel toolchain probe — kernel B3.

Port of ``scripts/pallas_probe.py``: one (8, 128) float32 ``x * 2 + 1``
kernel (``csrc/probe.cu``) that shows the CUDA toolchain builds, loads and
launches on the card.  :func:`probe_torch` is its plain version,
:func:`probe_cuda` its wrapper (launches counted in
``probe_cuda.launches``), and :func:`main` builds and runs it once and
prints ONE JSON line with the outcome:

    python -m forging_control_tpu_torch.ops.probe
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import torch

from . import build
from ..device import resolve_device


def probe_torch(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


def probe_cuda(x: torch.Tensor) -> torch.Tensor:
    """Hand-written CUDA kernel: x * 2 + 1 for a contiguous float32 CUDA
    tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"probe_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"probe_cuda takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe_cuda takes a contiguous tensor")
    fn = build.load("probe").lib.fct_probe_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    if rc != 0:
        raise RuntimeError(f"probe kernel launch failed: CUDA error {rc}")
    probe_cuda.launches += 1
    return y


probe_cuda.launches = 0


def main() -> int:
    device = resolve_device("cuda")
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    t0 = time.perf_counter()
    y = probe_cuda(x)
    torch.cuda.synchronize(device)
    ok = bool(torch.equal(y, probe_torch(x)))
    print(json.dumps({"ok": ok, "device": torch.cuda.get_device_name(device),
                      "build_plus_run_s": round(time.perf_counter() - t0,
                                                2)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
