"""Published peaks of the card, and a kernel's least time against them.

NVIDIA H100 SXM (80 GB HBM3) data sheet, dense rates at the full 700 W
power limit, outside the tensor cores (the port's hand-written kernels use
none): 67 TFLOP/s in float32, 34 TFLOP/s in float64; 3.35 TB/s of HBM
bandwidth.  A card set below 700 W runs slower under load; the result line
records its ``power_limit``.
"""

from __future__ import annotations

FLOPS = {"float32": 67e12, "float64": 34e12}
HBM_BYTES_PER_S = 3.35e12


def least_time(ops: float, nbytes: float, dtype: str = "float32") -> float:
    """Seconds: the larger of the operations over the dtype's rate and the
    bytes over the bandwidth."""
    return max(ops / FLOPS[dtype], nbytes / HBM_BYTES_PER_S)
