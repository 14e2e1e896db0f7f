"""Wide-panel closed-loop evaluation with confidence intervals.

Port of ``forging_control_tpu/eval/wide_panel.py``: roll a controller over
a wide panel of fresh reference streams x independent noise realisations
in ONE batched closed loop and report the mean +- 95% CI over
per-trajectory MAEs; two controllers evaluated with the same
:class:`PanelSpec` face identical plateau streams and noise realisations,
so :func:`compare` is a paired design.  Per-trajectory MAE is the
replication unit; its mean equals the panel-wide pooled MAE (equal
trajectory lengths), so it compares directly with reference-style table
rows.

The plateau streams and the process noise are drawn from CPU
``torch.Generator``s seeded with ``stream_key`` and ``noise_key`` (not the
JAX package's ``jax.random`` draws), or passed in; the statistics are NumPy
code, the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device
from ..loop import closed_loop as cl
from ..physics import press
from ..refgen import streams

# Dataset-generation process noise (Generate Data/Main.py:49-58), the
# noisy eval rows' plant disturbance.
PROCESS_STD = (5e-1, 2e0, 5e7, 5e7, 2e0)


@dataclasses.dataclass(frozen=True)
class PanelSpec:
    """A reproducible evaluation panel: ``n_streams`` fresh plateau streams
    of the reference variant's distribution, each rolled under
    ``n_noise_reps`` process-noise realisations, ``n_streams *
    n_noise_reps`` trajectories in one batch (the JAX package's fields)."""

    n_streams: int = 64
    n_noise_reps: int = 4
    t_traj: int = 300
    ref_variant: str = "supervised"
    variant: str = "smooth"
    process_std: tuple = PROCESS_STD
    stream_key: int = 7       # seed of the plateau draws
    noise_key: int = 101      # seed of the noise draws
    include_protocol_streams: bool = False  # prepend the 2 CPython streams

    @property
    def n_traj(self) -> int:
        base = self.n_streams + (2 if self.include_protocol_streams else 0)
        return base * self.n_noise_reps


def panel_refs(spec: PanelSpec, dtype=torch.float32, device="cuda"):
    """(S, T) plateau streams for the panel (before noise replication),
    drawn from a CPU generator seeded with ``spec.stream_key``."""
    fresh = streams.sample_references(
        torch.Generator().manual_seed(spec.stream_key), spec.n_streams,
        spec.ref_variant, spec.t_traj, dtype=dtype, device=device)
    if spec.include_protocol_streams:
        exact = torch.as_tensor(streams.reference_table(
            2, spec.ref_variant, spec.t_traj), device=fresh.device).to(dtype)
        fresh = torch.cat([exact, fresh], dim=0)
    return fresh


@dataclasses.dataclass
class PanelResult:
    """Per-trajectory tracking errors over the panel, (n_noise_reps, S)
    arrays: replication r of stream s is trajectory r * S + s."""

    spec: PanelSpec
    mae: np.ndarray          # (R, S) per-trajectory MAE
    rmse: np.ndarray         # (R, S)
    command: np.ndarray      # (R, S) mean |u|

    def summarize(self) -> dict:
        x = self.mae.ravel()
        n = x.size
        sem = float(x.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
        return {
            "mean": float(x.mean()),
            "std": float(x.std(ddof=1)) if n > 1 else 0.0,
            "sem": sem,
            "ci95": 1.96 * sem,
            "n": int(n),
            "rmse_mean": float(self.rmse.mean()),
            "command_mean": float(self.command.mean()),
        }


def run_controller(spec: PanelSpec, controller, *, dtype=torch.float32,
                   device="cuda", refs=None, process_noise=None,
                   run_fn=None) -> PanelResult:
    """Roll ``controller`` over the whole panel in one batched closed loop.

    ``refs`` (S, T) replaces :func:`panel_refs`; ``process_noise`` (R * S,
    T, 5, already scaled) replaces the draws of a CPU generator seeded with
    ``spec.noise_key``.  ``run_fn(x0, refs, generator) -> (x_final,
    Telemetry)`` replaces the loop engine (tests substitute tiny engines).
    """
    device = resolve_device(device)
    refs_s = (panel_refs(spec, dtype, device) if refs is None
              else torch.as_tensor(np.asarray(refs), device=device).to(dtype))
    S = refs_s.shape[0]
    R = spec.n_noise_reps
    all_refs = refs_s.repeat(R, 1)                          # (R*S, T)
    x0 = torch.tensor(press.X0_REFERENCE, dtype=dtype,
                      device=device).repeat(R * S, 1)
    loop_cfg = cl.LoopConfig(t_steps=spec.t_traj, variant=spec.variant,
                             process_std=spec.process_std)
    gen = torch.Generator().manual_seed(spec.noise_key)
    if run_fn is None:
        def run_fn(x, r, g):
            with torch.no_grad():
                return cl.run_batch(loop_cfg, controller, x, r, g,
                                    process_noise=process_noise,
                                    device=device)
    _, telem = run_fn(x0, all_refs, gen)

    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    ref = host(telem.ref)                                   # (R*S, T)
    y_dot = host(telem.x)[..., 1]
    u = host(telem.u)
    mae = np.abs(ref - y_dot).mean(axis=1).reshape(R, S)
    rmse = np.sqrt(((ref - y_dot) ** 2).mean(axis=1)).reshape(R, S)
    command = np.abs(u).mean(axis=1).reshape(R, S)
    return PanelResult(spec=spec, mae=mae, rmse=rmse, command=command)


def compare(a: PanelResult, b: PanelResult) -> dict:
    """Paired comparison of two controllers run on the SAME spec: the mean
    per-trajectory MAE difference (a - b) with its 95% CI and a verdict,
    "a_beats_b" / "b_beats_a" when the CI excludes zero, else "tie"."""
    if a.spec != b.spec:
        raise ValueError("paired comparison requires identical PanelSpecs")
    d = (a.mae - b.mae).ravel()
    n = d.size
    sem = float(d.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
    mean = float(d.mean())
    ci = 1.96 * sem
    if mean + ci < 0:
        verdict = "a_beats_b"
    elif mean - ci > 0:
        verdict = "b_beats_a"
    else:
        verdict = "tie"
    return {"mean_diff": mean, "sem": sem, "ci95": ci, "n": int(n),
            "win_rate_a": float((d < 0).mean()), "verdict": verdict}


def verdict_vs_scalar(result: PanelResult, recorded: float) -> dict:
    """Judge a panel mean against a recorded scalar baseline (a single
    draw, so not a paired test): "beats" needs the margin to exceed the
    panel's own 95% CI."""
    s = result.summarize()
    margin = s["mean"] - recorded    # negative = we are better
    if margin + s["ci95"] < 0:
        verdict = "beats"
    elif margin - s["ci95"] > 0:
        verdict = "loses"
    else:
        verdict = "tie"
    return {**s, "recorded": recorded, "margin": float(margin),
            "verdict": verdict}
