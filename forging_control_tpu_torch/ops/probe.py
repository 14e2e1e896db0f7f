"""Kernel toolchain probe — kernel B3.

Port of ``scripts/pallas_probe.py``: one (8, 128) float32 ``x * 2 + 1``
kernel (``csrc/probe.cu``) that shows the CUDA toolchain builds, loads and
launches on the card.  :func:`probe_torch` is its plain version,
:func:`probe_cuda` its wrapper (launches counted under ``"probe"`` by
``build.launch``), and :func:`main` builds and runs it once and
prints ONE JSON line with the outcome:

    python -m forging_control_tpu_torch.ops.probe [--host-us]

``--host-us`` adds to that line the host microseconds per call of the
wrapper, of ``torch.add`` and of the pieces of the wrapper's host cost
(:func:`host_breakdown`).
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys
import time

import torch

from . import build
from ..device import resolve_device


def probe_torch(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0 + 1.0


_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p)


def probe_cuda(x: torch.Tensor) -> torch.Tensor:
    """Hand-written CUDA kernel: x * 2 + 1 for a contiguous float32 CUDA
    tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"probe_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"probe_cuda takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("probe_cuda takes a contiguous tensor")
    fn = build.entry("probe", "fct_probe_f32", _ARGTYPES)
    y = torch.empty_like(x)
    build.launch("probe", fn, x.device, x.data_ptr(), y.data_ptr(),
                 x.numel())
    return y


def host_breakdown(x: torch.Tensor, n: int = 200, rounds: int = 5) -> dict:
    """Host microseconds per call of ``probe_cuda(x)``, of ``torch.add`` on
    x, and of the pieces of the wrapper's host cost: the median over
    ``rounds`` rounds, in which each takes its turn, of a ``perf_counter``
    over n calls without a synchronise."""
    one = torch.ones((), device=x.device)
    index = x.device.index
    pieces = {
        "probe_cuda": lambda: probe_cuda(x),
        "torch.add": lambda: torch.add(one, x, alpha=2.0),
        "torch.empty_like": lambda: torch.empty_like(x),
        "build.current_stream_handle":
            lambda: build.current_stream_handle(index),
        "torch.cuda.current_stream().cuda_stream":
            lambda: torch.cuda.current_stream().cuda_stream}
    times = {name: [] for name in pieces}
    for fn in pieces.values():
        fn()
    for _ in range(rounds):
        for name, fn in pieces.items():
            torch.cuda.synchronize(x.device)
            t = time.perf_counter()
            for _ in range(n):
                fn()
            times[name].append((time.perf_counter() - t) / n * 1e6)
    torch.cuda.synchronize(x.device)
    return {name: statistics.median(v) for name, v in times.items()}


def main(host_us: bool = False) -> int:
    device = resolve_device("cuda")
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device=device).reshape(8, 128)
    t0 = time.perf_counter()
    y = probe_cuda(x)
    torch.cuda.synchronize(device)
    ok = bool(torch.equal(y, probe_torch(x)))
    rec = {"ok": ok, "device": torch.cuda.get_device_name(device),
           "build_plus_run_s": round(time.perf_counter() - t0, 2)}
    if host_us:
        rec["host_us"] = host_breakdown(x)
    print(json.dumps(rec))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(host_us="--host-us" in sys.argv[1:]))
