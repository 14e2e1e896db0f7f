"""Typed experiment configuration.

A copy of ``forging_control_tpu/pipelines/config.py`` (pure Python), kept in
the port so that it imports nothing of the JAX package; saved configs load
in either package.

Replaces the reference's module-level USER SETTINGS constant blocks
(``Supervised Learning/Main.py:62-135``, ``Generate Data/Main.py:40-58``)
with dataclasses carrying the same switch set (SURVEY.md section 5,
"Config / flag system").
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Flags:
    """USER SETTINGS booleans (Supervised Learning/Main.py:62-80)."""

    enable_mpc: bool = True
    silence_solver: bool = True
    enable_noise: bool = False
    enable_training: bool = True
    enable_feasibility: bool = False
    show_plots: bool = False
    show_comparison: bool = False
    enable_debug: bool = False


# Process-noise std per state for dataset generation
# (Generate Data/Main.py:49-58).
PROCESS_STD = (5e-1, 2e0, 5e7, 5e7, 2e0)
MEAS_STD = (0.0, 0.0, 0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Dataset generation (Generate Data/Main.py:40-58)."""

    n_traj: int = 80
    t_traj: int = 300
    horizon: int = 25
    variant_model: str = "raw"        # Generate Data uses the raw model
    ref_variant: str = "generate"
    process_std: tuple = PROCESS_STD
    meas_std: tuple = MEAS_STD
    # Solver preset: "default" (feasible), "fast" (throughput), or
    # "ipopt_compat" (reproduces the recorded IPOPT's transient behavior —
    # see sqp.MPCConfig.ipopt_compat).
    solver_preset: str = "default"
    # Per-iteration solver trace in the telemetry (Diagnostics.trace) —
    # feeds the optimizer-diagnostics dashboard's convergence panels.
    record_trace: bool = False
    # Solver backend: "sqp" (condensed GN), "ilqr" (AL-iLQR Riccati), or
    # "auto" — measured-best per horizon (loop.closed_loop.resolve_backend:
    # sqp for N <= 12, ilqr beyond; the N=25 flagship runs 13x faster on
    # the Riccati backend).
    backend: str = "auto"
    flags: Flags = Flags()


@dataclasses.dataclass(frozen=True)
class SupervisedConfig:
    """Supervised run (Supervised Learning/Main.py:86-135)."""

    horizon: int = 10
    n_traj_eval: int = 2
    t_traj: int = 300
    lr: float = 1e-3
    # Reference protocol is 20 epochs (Main.py:272-286); 60 improves test
    # imitation MAE 0.0080 -> 0.0059-0.0068 (scripts/sup_quality_sweep.py,
    # 3 seeds, matching the reference's 0.0059) at ~2 s extra train time;
    # closed-loop tracking is unchanged (the FNN's closed-loop ceiling is
    # set by the architecture, measured identical for the reference's own
    # shipped weights under a matched 16-stream protocol).
    epochs: int = 60
    batch_size: int = 256
    hidden_dim: int = 50
    width_dim: int = 1
    scaler: str = "maxabs"
    # Declared closed-loop bounds (Supervised Learning/Main.py:122).  The
    # reference never applies them to the NN output (see nn/fnn.make_policy);
    # None reproduces that behavior, set values to opt into hard saturation.
    lb_u: float | None = None
    ub_u: float | None = None
    solver_preset: str = "default"    # MPC baseline eval solver (see
                                      # GenerateConfig.solver_preset)
    backend: str = "auto"             # see GenerateConfig.backend
    # Measure honest per-step latency distributions (Mean/Std/Median/
    # p25/p75) through the single-stream stepper for the result tables,
    # like the reference's do_mpc Timer stats; the batched engine's
    # amortized per-solve number is reported as its own Amortized_time
    # column.  Costs one extra AOT stepper compile per controller.
    latency_profile: bool = True
    # Independent training replicas, best selected by true-plant
    # closed-loop validation MAE (cf. the reference's 10 "sim" replicas,
    # Supervised Learning/Main.py sim loop).
    n_seeds: int = 1
    # "imitation": the reference protocol — one-shot behavior cloning of
    # the recorded teacher dataset (Supervised Learning/Main.py:272-286).
    # "dagger": iterated imitation — the batched MPC teacher relabels the
    # student's own closed-loop states each round (nn/train.train_dagger),
    # closing the covariate-shift gap one-shot cloning pays in closed
    # loop.  Unlike the unsupervised slot's dagger mode, NO plant-BPTT
    # fine-tune is applied: the slot stays pure imitation (labels come
    # only from the teacher), so the supervised/unsupervised distinction
    # keeps the reference's meaning.
    train_mode: str = "imitation"
    dagger_rounds: int = 4
    dagger_n_traj: int = 16           # fresh streams labeled per round
    dagger_epochs: int = 30           # imitation epochs per round
    flags: Flags = Flags()


@dataclasses.dataclass(frozen=True)
class SurrogateConfig:
    """LSTM surrogate run (Unsupervised Learning/Model_NN/Main.py)."""

    horizons: tuple = (5, 10, 15, 20, 25)
    lookback: int = 10
    hidden_dim: int = 50
    num_layers: int = 3
    lr: float = 1e-3
    epochs: int = 50
    batch_size: int = 256
    flags: Flags = Flags()


@dataclasses.dataclass(frozen=True)
class UnsupervisedConfig:
    """MPC-loss controller run (Unsupervised Learning/Main.py:86-135)."""

    horizon: int = 10
    lookback: int = 10
    alpha: float = 20.0
    # Reference protocol is constant lr=1e-4 (Main.py:326-348); the
    # measured-best schedule is cosine decay from 1e-3 over the run
    # (scripts/unsup_quality_sweep.py: test imitation MAE 0.0105-0.0116 vs
    # 0.0136-0.0149 at constant 1e-4, same 60-epoch budget, all 3 seeds;
    # noisy closed-loop val 0.070-0.072 vs 0.077-0.085).  Set
    # lr_schedule="constant", lr=1e-4 for the reference protocol.
    lr: float = 1e-3
    lr_schedule: str = "cosine"       # "cosine" | "constant"
    epochs: int = 20
    total_batch_size: int = 150       # BATCH_SIZE = 150 // N (Main.py:282-309)
    # Select the best epoch by true-plant closed-loop tracking MAE instead
    # of MSE-vs-recorded-MPC.  No reference counterpart (their plant
    # rollout costs minutes per candidate; ours costs milliseconds) —
    # guards against the controller exploiting surrogate error.
    closed_loop_val: bool = True
    closed_loop_val_traj: int = 16   # noisy selection needs the wider panel
    # "surrogate": reference protocol — MPC-loss unrolled through the frozen
    # LSTM surrogate (Unsupervised Learning/Main.py:326-348).  "plant":
    # TPU-native alternative — analytic policy gradients through the true
    # differentiable RK4 plant (nn/train.train_plant_in_loop); no surrogate
    # bias to exploit, same controller architecture and deployment path.
    # "dagger": iterated imitation with the batched MPC teacher relabeling
    # the student's own closed-loop states (nn/train.train_dagger) — fixes
    # imitation covariate shift; affordable only because one labeling pass
    # is a single fused batched program here.
    train_mode: str = "surrogate"
    # DAgger knobs (train_mode="dagger").
    dagger_rounds: int = 4
    dagger_n_traj: int = 16           # fresh streams labeled per round
    dagger_epochs: int = 30           # imitation epochs per round
    # Plant-BPTT fine-tune after DAgger (measured eval MAE 0.0493 vs
    # 0.0499 DAgger-only vs reference 0.0559; scripts/unsup_win_exp.py).
    dagger_plant_finetune: bool = True
    # Teacher solver preset for DAgger labeling (see GenerateConfig
    # .solver_preset); the chain runner passes its --preset through so the
    # student imitates the same teacher that generated its round-0 data.
    solver_preset: str = "default"
    plant_steps: int = 300            # optimizer steps for train_mode="plant"
    plant_n_traj: int = 32            # fresh reference streams per step
    # Warm-start the plant-in-loop policy by imitation pretraining on the
    # teacher dataset before fine-tuning through the plant.  Measured on
    # the noisy 16-stream validation protocol: from-scratch plant training
    # plateaus at 0.102-0.112 MAE; imitation pretrain + plant fine-tune
    # reaches 0.072 (reference's best shipped weights: 0.071; MPC: 0.062).
    plant_pretrain: bool = True
    plant_pretrain_epochs: int = 20
    plant_lr: float = 1e-4            # fine-tune lr; use ~1e-3 from scratch
    latency_profile: bool = True      # see SupervisedConfig.latency_profile
    # Train n_seeds independent controllers and keep the one with the best
    # true-plant closed-loop validation MAE.  The reference trains 10 "sim"
    # replicas per config (Supervised Learning/Main.py sim loop) and their
    # shipped weights spread 0.058-0.071 closed-loop MAE — seed selection
    # is part of its protocol; ours selects on held-out val streams.
    n_seeds: int = 1
    flags: Flags = Flags()

    @property
    def batch_size(self) -> int:
        return self.total_batch_size // self.horizon


# ---------------------------------------------------------------------------
# Hyperparameter-bundle persistence (Save_Network_Data equivalent)
# ---------------------------------------------------------------------------

_CONFIG_TYPES = None  # populated lazily from module globals


def _config_registry():
    global _CONFIG_TYPES
    if _CONFIG_TYPES is None:
        _CONFIG_TYPES = {
            c.__name__: c
            for c in (Flags, GenerateConfig, SupervisedConfig,
                      SurrogateConfig, UnsupervisedConfig)
        }
    return _CONFIG_TYPES


def save_config(path: str, cfg) -> None:
    """Persist a config dataclass as JSON.

    Replaces the reference's pickled ``Save_Network_Data`` hyperparameter
    record (``Unsupervised Learning/Model_NN/Functions.py:1076-1114``,
    saved to ``results/NN_model_data.bin``) — but human-readable and
    version-skew-proof (the reference's pickle load broke across
    sklearn/torch versions and was replaced by a hand-coded dummy,
    ``Unsupervised Learning/Main.py:144-151``).
    """
    import json

    rec = {"__config__": type(cfg).__name__,
           **dataclasses.asdict(cfg)}
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=list)


def load_config(path: str):
    """Reload a config saved by :func:`save_config` (exact round trip)."""
    import json

    with open(path) as f:
        rec = json.load(f)
    cls = _config_registry()[rec.pop("__config__")]
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kw = {}
    for k, v in rec.items():
        if k == "flags":
            v = Flags(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
        assert k in fields, f"unknown field {k!r} for {cls.__name__}"
    return cls(**kw)
