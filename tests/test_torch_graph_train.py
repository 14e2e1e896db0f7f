"""The captured training steps on the CPU (float64): what a CUDA graph of
one training step needs and what it must reproduce.

On a card every trainer of ``nn/train.py`` runs its steps (forward,
backward, gradient clipping, the AdamW update) as replays of one CUDA
graph (``loop.graph.Step``).  A capture needs a step that makes no tensor
from host data, reads no scalar back and calls no ``nonzero``; the replays
must equal the eager trainer (``graph=False``).  Here the step body runs
uncaptured on its static buffers (``Period.capture``, the one step that
needs a card, patched out, and ``graph.resolve`` patched to let the static
path run on the CPU), held bitwise against ``graph=False``.  The optimizer
arithmetic that the step captures (``nn/optim.py``) is held against optax.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.loop import graph
from forging_control_tpu_torch.nn import fnn, lstm, optim, scalers, train
from forging_control_tpu_torch.parallel.mesh import Mesh
from forging_control_tpu_torch.solver import sqp

F64 = torch.float64
SYNCING = ("aten.lift_fresh", "aten._local_scalar_dense", "aten.nonzero")
# nn/optim.py against optax, float64: the same ops in the same order, so
# only the last bits of pow and cos may differ.
OPTAX_RTOL, OPTAX_ATOL = 1e-12, 1e-15


class _SyncCounter(TorchDispatchMode):
    """Counts the ops that make a tensor from host data or synchronise."""

    def __init__(self):
        super().__init__()
        self.found = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        if name.startswith(SYNCING):
            self.found[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def static_steps(monkeypatch):
    """Trainers run the static-buffer step on the CPU: ``graph.resolve``
    lets ``graph=True`` through, ``Period.capture`` is a no-op (so every
    call runs the body on the buffers), and every step body runs under a
    ``_SyncCounter``, whose counts are returned in a list."""
    found = []
    run = graph.Period._run

    def counted(self):
        if not isinstance(self, graph.Step):
            return run(self)
        counter = _SyncCounter()
        with counter:
            out = run(self)
        found.append(dict(counter.found))
        return out

    monkeypatch.setattr(graph, "resolve", lambda g, device: g is not False)
    monkeypatch.setattr(graph.Period, "capture", lambda self: None)
    monkeypatch.setattr(graph.Period, "_run", counted)
    return found


def _fnn_params(seed=0, hidden=8):
    return fnn.init(torch.Generator().manual_seed(seed), hidden_dim=hidden,
                    dtype=F64, device="cpu")[0]


def _scalers():
    return (scalers.Scaler(torch.tensor([0.0, 0.0, 0.3], dtype=F64),
                           torch.tensor([0.5, 0.5, 0.3], dtype=F64)),
            scalers.Scaler(torch.zeros(1, dtype=F64),
                           torch.full((1,), 0.25, dtype=F64)))


def _supervised(g):
    rng = np.random.RandomState(1)
    x = rng.uniform(-1, 1, (100, 3))
    y = np.tanh(x[:, :1] - 0.5 * x[:, 1:2]) + 0.05 * rng.randn(100, 1)
    return train.train_supervised(_fnn_params(), x, y, x[:30], y[:30],
                                  width_dim=2, epochs=2, batch_size=32,
                                  seed=3, graph=g)


def _dagger(g):
    rng = np.random.RandomState(2)
    x, u = rng.uniform(-1, 1, (40, 3)), rng.uniform(-0.5, 0.5, (40, 1))
    return train.train_dagger(
        _fnn_params(), *_scalers(), x, u, x[:10], u[:10],
        mpc_cfg=sqp.MPCConfig.fast(horizon=3, gn_iters=2), rounds=2,
        n_traj=2, t_steps=2, epochs=1, batch_size=16, seed=1, graph=g)


def _surrogate(g):
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(64, 4, 5))
    y = torch.from_numpy(np.tanh(rng.randn(64, 4)))
    model = lstm.init(torch.Generator().manual_seed(4), hidden_dim=8,
                      num_layers=2, dtype=F64, device="cpu")
    model, rep = train.train_surrogate(model, x, y, x[:16], y[:16],
                                       epochs=2, batch_size=16, seed=5,
                                       graph=g)
    return {n: v.detach().clone() for n, v in model.named_parameters()}, rep


def _unsupervised(g):
    rng = np.random.RandomState(4)
    surrogate = lstm.init(torch.Generator().manual_seed(6), hidden_dim=8,
                          num_layers=2, dtype=F64, device="cpu")
    n, lookback = 30, 4
    x = rng.uniform(-1, 1, (n, 3))
    z = 0.3 * rng.randn(n, lookback, 5)
    u = rng.uniform(-0.5, 0.5, (n, 1))
    return train.train_unsupervised(
        _fnn_params(), surrogate, x, u, z, x[:8], u[:8], horizon=3,
        epochs=2, batch_size=7, enable_noise=True, seed=7,
        lr=train.cosine_decay_schedule(1e-2, 8), graph=g)



def _plant(g):
    """4 steps: step 1's references hold a NaN (a non-finite gradient: no
    update, and a rewind), step 2's are far off the plant's range (a
    rewind after an applied update)."""
    T, B = 4, 2
    rng = np.random.RandomState(5)
    refs = [rng.uniform(0.05, 0.4, (B, T)) for _ in range(4)]
    refs[1][0, 2] = np.nan
    refs[2][:] = 30.0
    noise = [rng.randn(B, T, 5) * (1e-3, 1e-2, 1e4, 1e4, 1e-2)
             for _ in range(4)]
    p, rep = train.train_plant_in_loop(
        _fnn_params(), *_scalers(), t_steps=T, n_traj=B, steps=4, lr=3e-2,
        seed=2, refs=refs, noise=noise, val_every=2,
        closed_loop_val_fn=lambda p: float(p["w_out"].abs().sum()),
        graph=g)
    assert rep.train_losses[1] == rep.train_losses[2] == rep.train_losses[0]
    return p, rep


def _plant_own_draws(g):
    """2 steps on the streams and the plant noise that the trainer draws
    from its own generator, outside the step."""
    return train.train_plant_in_loop(
        _fnn_params(), *_scalers(), t_steps=3, n_traj=2, steps=2, seed=1,
        process_std=(5e-4, 2e-3, 5e4, 5e4, 2e-3), graph=g)


TRAINERS = {"supervised": _supervised, "dagger": _dagger,
            "surrogate": _surrogate, "unsupervised": _unsupervised,
            "plant": _plant, "plant_own_draws": _plant_own_draws}
# Step bodies each static run calls (on a card: the first eager, the rest
# replays): epochs x batches, or the plant's steps.
STEPS = {"supervised": 2 * 3, "dagger": 2 + 2, "surrogate": 2 * 4,
         "unsupervised": 2 * 4, "plant": 4, "plant_own_draws": 2}


def _assert_runs_equal(a, b):
    (pa, ra), (pb, rb) = a, b
    assert list(pa) == list(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert ra.train_losses == rb.train_losses
    assert ra.val_losses == rb.val_losses
    assert ra.cl_val_losses == rb.cl_val_losses
    assert np.isfinite(ra.train_losses).all()


@pytest.mark.parametrize("name", list(TRAINERS))
def test_torch_static_train_step_equals_eager_and_never_syncs(
        name, static_steps):
    """The step body that a card captures, run on its static buffers
    (the first call eager, the others where the replays would be), equals
    ``graph=False`` bitwise: the parameters, the train, validation and
    selection losses.  No step body makes a tensor from host data, reads a
    scalar back or calls ``nonzero``."""
    eager = TRAINERS[name](False)
    assert static_steps == []            # graph=False uses no Step buffers
    static = TRAINERS[name](True)
    _assert_runs_equal(static, eager)
    assert len(static_steps) == STEPS[name]
    assert all(found == {} for found in static_steps), static_steps


def test_torch_static_plant_step_follows_its_seed(static_steps):
    """The equality above is not that of a step that ignores its inputs:
    another seed draws other streams and noise and trains other
    parameters."""
    a = _plant_own_draws(True)
    b = train.train_plant_in_loop(
        _fnn_params(), *_scalers(), t_steps=3, n_traj=2, steps=2, seed=9,
        process_std=(5e-4, 2e-3, 5e4, 5e4, 2e-3), graph=True)
    assert not torch.equal(a[0]["w_in"], b[0]["w_in"])


@pytest.mark.parametrize("name", ["supervised", "surrogate", "unsupervised",
                                  "plant"])
def test_torch_train_graph_true_needs_a_card(name):
    with pytest.raises(ValueError, match="CUDA"):
        TRAINERS[name](True)


@pytest.mark.parametrize("name", ["supervised", "surrogate"])
def test_torch_train_graph_true_refuses_a_mesh(name):
    """With ``mesh=`` the steps stay eager (the all-reduce is not
    captured): ``graph=True`` raises rather than switching modes."""
    mesh = Mesh("scenario", 2, 0, torch.device("cpu"))
    if name == "supervised":
        x = np.zeros((8, 3))
        with pytest.raises(ValueError, match="mesh"):
            train.train_supervised(_fnn_params(), x, x[:, :1], x, x[:, :1],
                                   epochs=1, mesh=mesh, graph=True)
    else:
        x = torch.zeros(8, 4, 5, dtype=F64)
        model = lstm.init(torch.Generator().manual_seed(0), hidden_dim=4,
                          num_layers=1, dtype=F64, device="cpu")
        with pytest.raises(ValueError, match="mesh"):
            train.train_surrogate(model, x, x[:, 0, :4], x, x[:, 0, :4],
                                  epochs=1, mesh=mesh, graph=True)


def _optax_pair(kind):
    """(optax's transform, the port's) of one kind."""
    sched = (optax.cosine_decay_schedule(1e-2, 5, alpha=0.05),
             optim.cosine_decay_schedule(1e-2, 5, alpha=0.05))
    if kind == "adamw":
        return (optax.adamw(3e-3, weight_decay=1e-2),
                optim.adamw(3e-3, weight_decay=1e-2))
    if kind == "adamw_cosine":
        return (optax.adamw(sched[0], weight_decay=1e-2),
                optim.adamw(sched[1], weight_decay=1e-2))
    if kind == "clip":
        return optax.clip_by_global_norm(1.0), optim.clip_by_global_norm(1.0)
    return (optax.apply_if_finite(optax.chain(
                optax.clip_by_global_norm(1.0),
                optax.adamw(sched[0], weight_decay=1e-2)), 2),
            optim.apply_if_finite(optim.chain(
                optim.clip_by_global_norm(1.0),
                optim.adamw(sched[1], weight_decay=1e-2)), 2))


@pytest.mark.parametrize("kind", ["adamw", "adamw_cosine", "clip",
                                  "apply_if_finite"])
def test_torch_optim_matches_optax(kind):
    """10 updates of the same gradients through optax and ``nn/optim.py``
    in float64: the parameters after each update within OPTAX_RTOL /
    OPTAX_ATOL.  The gradients' norm is about 3, so the clip scales them.
    For apply_if_finite (max_consecutive_errors 2), NaN gradients at
    updates 2, 4, 5, 6 and 7: 2, 4 and 5 are dropped, 6 is the third in a
    row and applied, and 7 too (NaN parameters from 6 on, as in optax);
    its counters (in a row, last finite, total) and the update count equal
    optax's after every update."""
    rng = np.random.RandomState(0)
    shapes = [(3, 4), (4,)]
    ps = [rng.randn(*s) for s in shapes]
    tx_j, tx_t = _optax_pair(kind)        # float64: conftest enables x64
    pj = [jnp.asarray(p) for p in ps]
    pt = [torch.from_numpy(p) for p in ps]
    sj, st = tx_j.init(pj), tx_t.init(pt)
    for k in range(10):
        g = [rng.randn(*s) for s in shapes]
        if kind == "apply_if_finite" and k in (2, 4, 5, 6, 7):
            g[0][1, 2] = np.nan
        uj, sj = tx_j.update([jnp.asarray(a) for a in g], sj, pj)
        pj = optax.apply_updates(pj, uj)
        ut, st = tx_t.update([torch.from_numpy(a) for a in g], st, pt)
        pt = optim.apply_updates(pt, ut)
        if kind == "apply_if_finite" and k >= 6:
            assert all(bool(torch.isnan(p).any()) for p in pt)
            assert all(bool(jnp.isnan(p).any()) for p in pj)
        else:
            for a, b in zip(pj, pt):
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=OPTAX_RTOL,
                                           atol=OPTAX_ATOL)
        if kind == "apply_if_finite":
            assert int(st.notfinite_count) == int(sj.notfinite_count)
            assert bool(st.last_finite) == bool(sj.last_finite)
            assert int(st.total_notfinite) == int(sj.total_notfinite)
            assert (float(st.inner_state[1].count)
                    == int(sj.inner_state[1][0].count))
    if kind == "apply_if_finite":
        assert int(st.total_notfinite) == 5
        assert float(st.inner_state[1].count) == 7


def test_torch_cosine_schedule_on_a_count_tensor_matches_optax():
    """The schedule of a float64 count tensor, as the captured step reads
    it, against optax's within OPTAX_RTOL, past the decay steps too."""
    for alpha in (0.0, 0.05):
        want = optax.cosine_decay_schedule(3e-3, 17, alpha=alpha)
        got = optim.cosine_decay_schedule(3e-3, 17, alpha=alpha)
        for t in (0, 1, 5, 16, 17, 40):
            out = got(torch.tensor(float(t), dtype=F64))
            assert out.dtype == F64 and out.shape == ()
            np.testing.assert_allclose(float(out), float(want(t)),
                                       rtol=OPTAX_RTOL, atol=1e-20)


def test_torch_closed_loop_selection_keeps_one_graph_key(monkeypatch):
    """``make_closed_loop_val`` holds one controller across calls, so
    ``run_batch``'s graph cache key is the same at every call (on a card
    every call after the first replays the period captured at the first);
    the scores equal a fresh selection function's for each candidate,
    bitwise."""
    in_sc, u_sc = _scalers()
    kw = dict(n_traj=2, t_traj=4, dtype=F64, device="cpu",
              process_std=(5e-4, 2e-3, 5e4, 5e4, 2e-3))
    keys, run_batch = [], cl.run_batch

    def spy(loop_cfg, controller, x0, *a, **k):
        keys.append(cl._graph_key(loop_cfg, controller, x0.shape[0],
                                  x0.dtype, x0.device))
        return run_batch(loop_cfg, controller, x0, *a, **k)

    monkeypatch.setattr(cl, "run_batch", spy)
    val = train.make_closed_loop_val(in_sc, u_sc, **kw)
    cands = [_fnn_params(s) for s in (0, 1, 0, 2)]
    got = [float(val(p)) for p in cands]
    assert keys[0] is not None and keys == [keys[0]] * 4
    want = [float(train.make_closed_loop_val(in_sc, u_sc, **kw)(p))
            for p in cands]
    assert got == want
    assert got[0] == got[2] != got[1]
