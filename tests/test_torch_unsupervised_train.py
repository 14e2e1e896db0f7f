"""The port's MPC-loss and plant-in-loop trainers against the JAX package
(float64, CPU), fed the JAX package's draws: ``train_unsupervised`` with its
batch tables and per-batch noise keys recomputed here (loss curves, returned
parameters and the best-epoch choice, with and without a closed-loop
selection function, on a constant rate and on the cosine schedule), and
``train_plant_in_loop`` for 4 steps at T = 10, n_traj = 2 with its
reference streams and plant noise, including a non-finite step that applies
no update and two rewinds to the snapshot.  Tolerance 1e-8."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from forging_control_tpu.loop import closed_loop as jcl
from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import scalers, train

HORIZON, LOOKBACK, N_TRAIN, BS = 3, 4, 40, 8


def _data(seed):
    rng = np.random.RandomState(seed)
    ctrl = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(seed), hidden_dim=16, dtype=jnp.float64)[0])
    surr = jax.tree.map(np.asarray, jlstm.init(
        jax.random.PRNGKey(seed + 1), hidden_dim=8, num_layers=2,
        dtype=jnp.float64))
    xt = rng.uniform(-0.8, 0.8, (N_TRAIN, 3))
    ut = rng.uniform(-0.5, 0.5, (N_TRAIN, 1))
    zt = rng.uniform(-0.9, 0.9, (N_TRAIN, LOOKBACK, 5))
    xv = rng.uniform(-0.8, 0.8, (12, 3))
    uv = rng.uniform(-0.5, 0.5, (12, 1))
    return ctrl, surr, (xt, ut, zt, xv, uv)


def _jax_draws(seed, epochs, noisy):
    """The JAX trainer's batch tables and, when noisy, per-batch
    (N, B, 4) standard-normal draws (``_unsupervised_program``)."""
    perms, noise = [], []
    for ek in jax.random.split(jax.random.PRNGKey(seed), epochs):
        perm = np.asarray(jtrain._epoch_perm(ek, N_TRAIN, BS))
        perms.append(perm)
        bkeys = jax.random.split(jax.random.fold_in(ek, 1), perm.shape[0])
        noise.append([np.stack([np.asarray(jax.random.normal(
            k, (BS, 4), jnp.float64)) for k in jax.random.split(
                bk, HORIZON)]) for bk in bkeys] if noisy else None)
    return perms, noise


def _sequence(values):
    """A selection function that returns ``values`` in turn (the same
    sequence for both packages)."""
    it = iter(values)
    return lambda params: next(it)


@pytest.mark.parametrize("case", ["plain", "noisy_cosine", "closed_loop"])
def test_torch_train_unsupervised_matches_jax(case):
    seed, epochs = 3, 3
    ctrl, surr, (xt, ut, zt, xv, uv) = _data(seed)
    noisy = case == "noisy_cosine"
    steps = (N_TRAIN // BS) * epochs
    jlr = optax.cosine_decay_schedule(1e-2, steps) if noisy else 1e-2
    lr = train.cosine_decay_schedule(1e-2, steps) if noisy else 1e-2
    scores = [0.3, 0.1, 0.2]          # the closed-loop case picks epoch 1
    kw = dict(horizon=HORIZON, epochs=epochs, batch_size=BS,
              enable_noise=noisy, seed=seed)
    cl = case == "closed_loop"
    want_p, want = jtrain.train_unsupervised(
        ctrl, surr, xt, ut, zt, xv, uv, lr=jlr,
        closed_loop_val_fn=_sequence(scores) if cl else None, **kw)
    perms, noise = _jax_draws(seed, epochs, noisy)
    got_p, got = train.train_unsupervised(
        interop.fnn_params_from_numpy(ctrl, device="cpu"),
        interop.lstm_params_from_numpy(surr, device="cpu"),
        xt, ut, zt, xv, uv, lr=lr, perms=perms, noise=noise,
        closed_loop_val_fn=_sequence(scores) if cl else None, **kw)
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-8)
    np.testing.assert_allclose(got.val_losses, want.val_losses, rtol=1e-8)
    assert got.cl_val_losses == want.cl_val_losses
    for k, v in got_p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)
    if cl:
        # Not the last epoch's parameters: the best-scored epoch's.
        last, _ = train.train_unsupervised(
            interop.fnn_params_from_numpy(ctrl, device="cpu"),
            interop.lstm_params_from_numpy(surr, device="cpu"),
            xt, ut, zt, xv, uv, lr=lr, perms=perms, keep_best=False, **kw)
        assert not torch.equal(last["w_in"], got_p["w_in"])


def test_torch_cosine_schedule_matches_optax():
    for alpha in (0.0, 0.05):
        want = optax.cosine_decay_schedule(3e-3, 17, alpha=alpha)
        got = train.cosine_decay_schedule(3e-3, 17, alpha=alpha)
        for t in (0, 1, 5, 16, 17, 40):
            np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-14,
                                       atol=1e-20)
    assert got(0) == 3e-3
    with pytest.raises(ValueError):
        train.cosine_decay_schedule(1e-3, 0)


T_PLANT, N_PLANT = 10, 2
PROCESS_STD = (5e-1, 2e0, 5e7, 5e7, 2e0)


def test_torch_train_plant_in_loop_matches_jax(monkeypatch):
    """4 steps; step 1's streams hold a NaN (non-finite loss and gradient:
    no update, a rewind) and step 2's a reference far off the plant's range
    (a loss above 4 x the best: a rewind after an applied update)."""
    seed = 2
    rng = np.random.RandomState(seed)
    ctrl = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(seed), hidden_dim=16, dtype=jnp.float64)[0])
    shifts = (0.01 * rng.randn(3), 0.01 * rng.randn(1))
    scales = (rng.uniform(0.5, 1.0, 3), rng.uniform(0.2, 0.3, 1))
    jsc = [jscalers.Scaler(jnp.asarray(a), jnp.asarray(b))
           for a, b in zip(shifts, scales)]
    sc = [scalers.Scaler(torch.from_numpy(a), torch.from_numpy(b))
          for a, b in zip(shifts, scales)]

    # The JAX trainer's per-step keys; its streams are replaced below.
    key, refs, noise = jax.random.PRNGKey(seed), [], []
    loop = jcl.LoopConfig(t_steps=T_PLANT, process_std=PROCESS_STD)
    x0 = jnp.tile(jnp.asarray(jcl.press.X0_REFERENCE), (N_PLANT, 1))
    zero = jcl.FunctionController(lambda x, r, u: jnp.zeros((), x.dtype))
    for step in range(4):
        key, k_ref, k_noise = jax.random.split(key, 3)
        r = np.asarray(jstreams.sample_references(
            k_ref, N_PLANT, "unsupervised", T_PLANT, dtype=jnp.float64))
        if step == 1:
            r = r.copy()
            r[0, 3] = np.nan
        elif step == 2:
            r = np.full_like(r, 30.0)
        refs.append(r)
        # The plant noise does not depend on the commands: record it.
        noise.append(np.asarray(jcl.run_batch(loop, zero, x0, jnp.asarray(r),
                                              k_noise)[1].w))
    it = iter(refs)
    monkeypatch.setattr(jstreams, "sample_references",
                        lambda *a, **k: jnp.asarray(next(it)))

    kw = dict(t_steps=T_PLANT, n_traj=N_PLANT, steps=4, lr=3e-2, seed=seed,
              process_std=PROCESS_STD, val_every=1)
    scores = [0.3, 0.2, 0.25, 0.1]
    want_p, want = jtrain.train_plant_in_loop(
        ctrl, *jsc, closed_loop_val_fn=_sequence(scores), **kw)
    got_p, got = train.train_plant_in_loop(
        interop.fnn_params_from_numpy(ctrl, device="cpu"), *sc,
        closed_loop_val_fn=_sequence(scores), refs=refs, noise=noise, **kw)

    assert np.isfinite(want.train_losses).all()   # rewinds restore the loss
    assert want.train_losses[1] == want.train_losses[0]
    assert want.train_losses[2] == want.train_losses[0]
    np.testing.assert_allclose(got.train_losses, want.train_losses,
                               rtol=1e-8)
    assert got.cl_val_losses == want.cl_val_losses == scores
    for k, v in got_p.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want_p[k]),
                                   rtol=1e-8, atol=1e-12, err_msg=k)


def test_torch_train_plant_in_loop_draws_its_own_streams():
    """Without refs and noise, a generator seeded with ``seed`` draws them:
    the same seed trains the same parameters, and the losses are finite."""
    ctrl = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(0), hidden_dim=8, dtype=jnp.float64)[0])
    sc = (scalers.Scaler(torch.zeros(3, dtype=torch.float64),
                         torch.ones(3, dtype=torch.float64)),
          scalers.Scaler(torch.zeros(1, dtype=torch.float64),
                         torch.full((1,), 0.25, dtype=torch.float64)))
    runs = [train.train_plant_in_loop(
        interop.fnn_params_from_numpy(ctrl, device="cpu"), *sc, t_steps=5,
        n_traj=2, steps=2, seed=1, process_std=PROCESS_STD)
        for _ in range(2)]
    assert np.isfinite(runs[0][1].train_losses).all()
    for (a, _), (b, _) in itertools.combinations(runs, 2):
        for k in a:
            assert torch.equal(a[k], b[k])
