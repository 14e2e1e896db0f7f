"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference (``benchmark/reference``).

The program's output is the closed loop's telemetry: per period the
command u_t and, in the batched cells, the measured state after the
period.  A sample of streams (scenarios of a batched call, trajectories of
the single stream) is drawn from the run's seed.  For each sampled stream
the reference, in float64 on the CPU:

1. drives its own plant with the program's commands and the stream's
   noise from the stream's initial state (``reference.loop.replay``): the
   states the program's plant must have produced.  ``x_gap_p90`` is the
   90th percentile, over every period the sampled streams ran, of the
   largest gap between the program's measured state and the reference's,
   per component in units of the NLP's scaling (0.1 m, 0.1 m/s, 10 MPa,
   10 MPa, 0.01 m).  A percentile and not the widest gap: where a pressure
   falls through zero the plant turns rounding into gaps of 0.06 in
   float32 (the tests' CPU runs), at a few periods in a thousand;
2. runs its own controller on those states over the stretches of periods
   that the traffic's ``check`` names (``reference.loop.follow``), and
   compares its commands with the program's: for a stretch ``s``,
   ``u_gap.s`` is the widest gap, ``u_gap_p90.s`` and ``u_gap_p50.s`` the
   90th and 50th percentiles of the gaps over its sampled streams and
   periods.  A stretch starts ``at`` period 0 or at the reversal ("split":
   the first period of the return plateau), compares ``periods`` periods,
   and a stretch at 0 ends at the reversal at the latest.  The controller
   is a real-time iteration: a fixed number of Gauss-Newton iterations a
   period from the last period's solution, so a command depends on the
   history.  From period 0 the reference starts as the program does, from
   the configuration's cold start.  Before a later stretch it starts
   ``lead`` periods early, its warm start every stage at the program's
   previous command (the hot start), and carries its own warm start from
   there: on a plateau it then reaches, within ten periods, the commands
   of the reference that followed the whole history (the tests' CPU runs:
   the same bits at the reversal from 10 or 20 periods ahead on 8 streams;
   from 5 ahead, gaps of 0.012), whereas following the whole 300-period
   history costs some 190 s of the host, longer than a run may take.
   Every stretch runs in one batch of rows, as long as the longest.

A command or state that is not finite reads as an infinite gap.

The precision control is the same comparison with the reference in a
lower precision put in the program's place (:func:`gaps` with ``dtype``):
its plant driven by the same commands, its controller on the same states.
"""

from __future__ import annotations

import torch

from .reference import loop as ref_loop
from .reference import physics as ph


def _inf(a):
    return torch.nan_to_num(a, nan=float("inf"), posinf=float("inf"),
                            neginf=float("inf"))


def stretches(traffic: dict, T: int) -> list:
    """(name, first compared period, periods compared, first followed
    period) of each stretch of a traffic's ``check`` at T periods a
    stream."""
    split = int(round(traffic["reference"]["split"] * T))
    out = []
    for s in traffic["check"]["stretches"]:
        at = split if s["at"] == "split" else int(s["at"])
        end = min(at + s["periods"], split if at < split else T)
        if end > at:
            out.append((s["name"], at, end - at,
                        max(0, at - s.get("lead", 0))))
    return out


def periods(traffic: dict, T: int) -> int:
    """The periods a stream must have run for every stretch."""
    return max(a + n for _, a, n, _ in stretches(traffic, T))


def gaps(cfg, rows, traffic: dict, dtype=torch.float64) -> dict:
    """The numbers for sampled streams ``rows`` over the stretches of the
    traffic's ``check``, and ``x_gap_p90`` where the streams carry
    states; a cell's limits say which it compares.  A stream holds "x0"
    (5,), "refs" (T,), "noise" (T, 5), and the program's telemetry "u"
    (T_done,) and optionally "x" (T_done, 5).  With a ``dtype`` below
    float64 the reference in that dtype stands in the program's place.
    Streams that stop short of a stretch give no numbers."""
    if not rows:
        return {}
    f64 = torch.float64
    T = max(len(r["refs"]) for r in rows)
    done = torch.tensor([len(r["u"]) for r in rows])
    plan = stretches(traffic, T)
    if int(done.min()) < periods(traffic, T):
        return {}

    def padded(key, shape):
        out = torch.zeros(len(rows), T, *shape, dtype=f64)
        for i, r in enumerate(rows):
            a = torch.as_tensor(r[key], dtype=f64)
            out[i, :len(a)] = a
        return out
    u, refs, noise = _inf(padded("u", ())), padded("refs", ()), \
        padded("noise", (5,))
    x0 = torch.stack([torch.as_tensor(r["x0"], dtype=f64) for r in rows])
    with_x = all("x" in r for r in rows)
    n = T if with_x else periods(traffic, T)
    truth = ref_loop.replay(cfg, x0, u[:, :n], noise[:, :n])  # (R, n+1, 5)
    out = {}
    if with_x:
        if dtype == f64:
            got = padded("x", (5,))
        else:
            got = ref_loop.replay(cfg, x0.to(dtype), u.to(dtype),
                                  noise.to(dtype))[:, 1:].to(f64)
        scale = torch.tensor(ph.X_SCALE, dtype=f64)
        d = _inf((got - truth[:, 1:]).abs() / scale).amax(-1)
        live = torch.arange(T)[None] < done[:, None]
        out["x_gap_p90"] = float(torch.quantile(d[live], 0.9,
                                                  interpolation="higher"))

    # Every stretch's rows in one batch, each from its first followed
    # period, as long as the longest (the shorter ones padded with their
    # last compared period's inputs, not compared there).
    u_prev = torch.cat([torch.full((len(rows), 1), float(cfg["u_init"]),
                                   dtype=f64), u[:, :-1]], 1)
    L = max(a + k - f for _, a, k, f in plan)
    idx = torch.cat([torch.clamp(torch.arange(f, f + L), max=a + k - 1)
                     .expand(len(rows), L) for _, a, k, f in plan])
    xm = torch.gather(truth[:, :n].repeat(len(plan), 1, 1), 1,
                      idx[..., None].expand(-1, -1, 5))
    rw = torch.gather(refs.repeat(len(plan), 1), 1, idx)
    up = torch.gather(u_prev.repeat(len(plan), 1), 1, idx)
    hot = torch.cat([torch.full((len(rows),), f > 0) for *_, f in plan])

    def follow(dt):
        x, r, p = xm.to(dt), rw.to(dt), up.to(dt)
        return ref_loop.follow(cfg, x, r, p,
                               ref_loop.start(cfg, p[:, 0], hot))[0].to(f64)
    want = follow(f64)
    mine = u.repeat(len(plan), 1) if dtype == f64 else follow(dtype)
    for j, (name, a, k, f) in enumerate(plan):
        rs = slice(j * len(rows), (j + 1) * len(rows))
        got = mine[rs, a:a + k] if dtype == f64 else mine[rs, a - f:a - f + k]
        d = _inf((got - want[rs, a - f:a - f + k]).abs()).flatten()
        out[f"u_gap.{name}"] = float(d.max())
        for q in (90, 50):
            out[f"u_gap_p{q}.{name}"] = float(torch.quantile(
                d, q / 100, interpolation="higher"))
    return out


def verdict(found: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for the numbers that the cell's
    limits name: correct where each is at or under its limit; a number
    that could not be read is not correct."""
    table = {k: {"value": found.get(k), "limit": v}
             for k, v in sorted(limits.items())}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
