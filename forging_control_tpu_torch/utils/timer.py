"""Wall-clock tic/toc timer.

Port of ``forging_control_tpu/utils/timer.py``: the equivalent of
``do_mpc.tools.Timer`` used to bracket every controller step (``Generate
Data/Functions.py:335-337``) with the summary/percentile stats of
``Supervised Learning/Functions.py:546-560``.  It reads the host's clock:
on a card a caller synchronises before ``tic`` and ``toc`` to time the
device's work (the closed-loop latency rows use the steppers of
``loop/closed_loop.py``).
"""

from __future__ import annotations

import time

import numpy as np


class Timer:
    def __init__(self):
        self._t0 = None
        self.times: list[float] = []

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    def stats_ms(self) -> dict:
        t = np.asarray(self.times) * 1e3
        if t.size == 0:
            return {}
        return {
            "Mean_time": float(t.mean()),
            "Std_time": float(t.std()),
            "Median_time": float(np.percentile(t, 50)),
            "25_perc": float(np.percentile(t, 25)),
            "75_perc": float(np.percentile(t, 75)),
        }
