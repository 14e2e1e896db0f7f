"""The port's MPC loss against the JAX package (float64, CPU): the loss, its
per-sample decomposition and its gradient with respect to the controller,
with and without noise (the JAX package's ``jax.random.normal`` draws passed
in), at N = 1 and 3, rtol 1e-10; and the generator's noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.nn import mpc_loss as jmpc_loss
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import fnn, mpc_loss

B, LOOKBACK = 6, 4


def _setup(seed):
    rng = np.random.RandomState(seed)
    ctrl = jax.tree.map(np.asarray, jfnn.init(
        jax.random.PRNGKey(seed), hidden_dim=16, dtype=jnp.float64)[0])
    surr = jax.tree.map(np.asarray, jlstm.init(
        jax.random.PRNGKey(seed + 1), hidden_dim=8, num_layers=2,
        dtype=jnp.float64))
    x = rng.uniform(-0.8, 0.8, (B, 3))
    # Pressures near the scaled bounds, so every constraint term is live.
    win = rng.uniform(-0.9, 0.9, (B, LOOKBACK, 5))
    win[:, :, 1] = rng.uniform(-0.1, 2.2, (B, LOOKBACK))
    return ctrl, surr, x, win


def _jax_noise(key, horizon, shape):
    keys = jax.random.split(key, horizon)
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float64))
                     for k in keys])


@pytest.mark.parametrize("horizon", [1, 3])
@pytest.mark.parametrize("noisy", [False, True])
def test_torch_mpc_loss_and_grad_match_jax(horizon, noisy):
    ctrl, surr, x, win = _setup(horizon + 10 * noisy)
    key = jax.random.PRNGKey(5) if noisy else None

    def jloss(p):
        u = jfnn.apply(p, jnp.asarray(x), 1)
        return jmpc_loss.mpc_loss(p, surr, jnp.asarray(x), u,
                                  jnp.asarray(win), horizon=horizon,
                                  noise_key=key)

    (want, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(ctrl)

    p = {k: v.requires_grad_(True) for k, v in
         interop.fnn_params_from_numpy(ctrl, device="cpu").items()}
    model = interop.lstm_params_from_numpy(surr, device="cpu")
    xt = torch.from_numpy(x)
    noise = _jax_noise(key, horizon, (B, 4)) if noisy else None
    got, out = mpc_loss.mpc_loss(p, model, xt, fnn.apply(p, xt),
                                 torch.from_numpy(win), horizon=horizon,
                                 noise=noise)
    assert out.prediction.shape == (B, horizon)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-10)
    for name in ("loss", "command", "error", "prediction"):
        np.testing.assert_allclose(getattr(out, name).detach().numpy(),
                                   np.asarray(getattr(jout, name)),
                                   rtol=1e-10, atol=1e-14, err_msg=name)
    grads = torch.autograd.grad(got, list(p.values()), allow_unused=True)
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[k]),
                                   rtol=1e-10, atol=1e-13, err_msg=k)


def test_torch_mpc_loss_generator_noise_is_seeded():
    """Without pre-drawn noise a generator draws it: the same seed gives the
    same loss, another seed another, and no generator no noise."""
    ctrl, surr, x, win = _setup(4)
    p = interop.fnn_params_from_numpy(ctrl, device="cpu")
    model = interop.lstm_params_from_numpy(surr, device="cpu")
    xt, wt = torch.from_numpy(x), torch.from_numpy(win)

    def loss(gen):
        with torch.no_grad():
            return float(mpc_loss.mpc_loss(p, model, xt, fnn.apply(p, xt), wt,
                                           horizon=3, generator=gen)[0])

    a = loss(torch.Generator().manual_seed(1))
    assert a == loss(torch.Generator().manual_seed(1))
    assert a != loss(torch.Generator().manual_seed(2))
    assert loss(None) != a
