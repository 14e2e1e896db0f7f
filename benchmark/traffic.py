"""The benchmark's one traffic generator: the inputs of every cell, drawn
from the run's seed by the parameters of its traffic file.

A trajectory's speed reference is two plateaus, as the reference project
draws them (``Generate Data/template_mpc.py:57-84``, ``refgen/streams``):
the work plateau ``gain * r + offset`` for the first ``split`` of the
periods, then the return plateau ``-(gain * r' + offset)``, with r and r'
uniform on [0, 1).  The process noise is standard normal draws times the
configuration's ``process_std`` (``Generate Data/Main.py:49-58``), one
(5,) row a period, added to the plant's dx/dt.  Every draw of a unit of
traffic (a batched call, a trajectory of the single stream) comes from a
generator seeded by (seed, unit index), so a seed gives the same inputs
in any run, and the same sizes and arrivals under every seed.
"""

from __future__ import annotations

import numpy as np
import torch

WARMUP = -1          # the unit index of the set-up's own inputs
TRACED = -2          # and of the traced stretch's


def unit_seed(seed: int, index: int, stream: int = 0) -> int:
    """A 63-bit generator seed for unit ``index`` of the run's ``seed``
    (any whole number; the warm-up is the unit ``WARMUP``); ``stream``
    tells apart the draws of one unit (0: its inputs, 1: the check's
    sample)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, int(index) % 2 ** 64,
                                 stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def draw(traffic: dict, cfg: dict, seed: int, index: int, device, rows=None):
    """(refs (B, T), process noise (B, T, 5)) of unit ``index`` as tensors
    of the configuration's dtype on ``device``, drawn on ``device``: B is
    the traffic's ``batch``, T the configuration's ``t_steps``.  ``rows``
    (indices) returns those rows of the same draw only."""
    B, T = traffic["batch"], cfg["t_steps"]
    ref = traffic["reference"]
    g = torch.Generator(device=device)
    g.manual_seed(unit_seed(seed, index))
    dtype = getattr(torch, cfg["dtype"])
    kw = dict(generator=g, dtype=dtype, device=device)
    r_work = torch.rand(B, **kw)
    r_ret = torch.rand(B, **kw)
    noise = torch.randn(B, T, 5, **kw) * torch.tensor(
        cfg["process_std"], dtype=dtype, device=device)
    work = ref["gain"] * r_work + ref["offset"]
    ret = -(ref["gain"] * r_ret + ref["offset"])
    split = int(round(ref["split"] * T))
    is_work = torch.arange(T, device=device) < split
    refs = torch.where(is_work[None, :], work[:, None], ret[:, None])
    if rows is not None:
        rows = torch.as_tensor(rows, device=device)
        refs, noise = refs[rows], noise[rows]
    return refs, noise


def x0(cfg: dict, batch: int, device) -> torch.Tensor:
    """The configuration's initial state for every scenario."""
    return torch.tensor(cfg["x0"], dtype=getattr(torch, cfg["dtype"]),
                        device=device).repeat(batch, 1)
