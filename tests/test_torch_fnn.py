"""The port's FNN controller and its supervised training against the JAX
package (float64, CPU): ``apply``, ``apply_simulator`` and ``make_policy``
with the JAX package's weights carried across; ``train_supervised`` with its
initial weights and batch tables; ``make_closed_loop_val`` on its reference
streams; reverse mode at ties (the ``dual`` helpers on plain tensors and
the Hardtanh at its bounds) and through the closed loop
(``make_policy(cache=False)``) against ``jax.grad``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import fnn as jfnn
from forging_control_tpu.nn import scalers as jscalers
from forging_control_tpu.nn import train as jtrain
from forging_control_tpu.refgen import streams as jstreams
from forging_control_tpu_torch import dual as ad
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import fnn, scalers, train


def _jax_params(seed, width_dim=1, hidden_dim=50):
    params, _ = jfnn.init(jax.random.PRNGKey(seed), hidden_dim=hidden_dim,
                          width_dim=width_dim, dtype=jnp.float64)
    return jax.tree.map(np.asarray, params)


def _scalers(rng):
    shift_in, scale_in = 0.01 * rng.randn(3), rng.uniform(0.2, 1.0, 3)
    shift_out, scale_out = 0.01 * rng.randn(1), rng.uniform(0.1, 0.4, 1)
    port = (scalers.Scaler(torch.from_numpy(shift_in),
                           torch.from_numpy(scale_in)),
            scalers.Scaler(torch.from_numpy(shift_out),
                           torch.from_numpy(scale_out)))
    jax_ = (jscalers.Scaler(jnp.asarray(shift_in), jnp.asarray(scale_in)),
            jscalers.Scaler(jnp.asarray(shift_out), jnp.asarray(scale_out)))
    return port, jax_


@pytest.mark.parametrize("width_dim", [1, 3])
def test_torch_fnn_forward_and_policy_match_jax(width_dim):
    """apply, apply_simulator (with and without biases) and the batched
    policy (with and without explicit saturation), rtol 1e-12."""
    rng = np.random.RandomState(width_dim)
    params = _jax_params(width_dim, width_dim)
    p = interop.fnn_params_from_numpy(params, device="cpu")
    x = rng.randn(64, 3)
    np.testing.assert_allclose(
        fnn.apply(p, torch.from_numpy(x), width_dim).numpy(),
        np.asarray(jfnn.apply(params, jnp.asarray(x), width_dim)),
        rtol=1e-12, atol=1e-15)
    # Saturated rows reach the Hardtanh clamp.
    big = 40.0 * x
    out = fnn.apply(p, torch.from_numpy(big), width_dim).numpy()
    assert np.any(np.abs(out) == 1.0)
    np.testing.assert_allclose(
        out, np.asarray(jfnn.apply(params, jnp.asarray(big), width_dim)),
        rtol=1e-12, atol=1e-15)

    for bias in (False, True):
        sp, _ = jfnn.init_simulator(jax.random.PRNGKey(7), 5, 16, 4,
                                    width_dim, bias=bias, dtype=jnp.float64)
        sp = jax.tree.map(np.asarray, sp)
        xs = rng.randn(20, 5)
        np.testing.assert_allclose(
            fnn.apply_simulator(interop.fnn_params_from_numpy(sp,
                                                              device="cpu"),
                                torch.from_numpy(xs), width_dim).numpy(),
            np.asarray(jfnn.apply_simulator(sp, jnp.asarray(xs), width_dim)),
            rtol=1e-12, atol=1e-15)

    (in_sc, out_sc), (jin, jout) = _scalers(rng)
    xm = rng.randn(64, 5) * [0.05, 0.4, 1e7, 1e7, 0.1]
    ref = rng.uniform(-0.9, 0.9, 64)
    for lb, ub in ((None, None), (-0.05, 0.05)):
        pol = fnn.make_policy(p, in_sc, out_sc, width_dim, lb, ub)
        got = pol(torch.from_numpy(xm), torch.from_numpy(ref),
                  torch.zeros(64, dtype=torch.float64)).numpy()
        jpol = jfnn.make_policy(params, jin, jout, width_dim, lb, ub)
        want = np.array([float(jpol(jnp.asarray(xm[i]), ref[i], 0.0))
                         for i in range(64)])
        assert got.shape == (64,)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    assert np.max(np.abs(got)) == 0.05


def test_torch_fnn_policy_casts_float32_weights():
    """float32 weights and scalers in a float64 loop compute in float64, as
    JAX promotes them; the copies are made once per (device, dtype)."""
    rng = np.random.RandomState(3)
    params = jax.tree.map(lambda a: a.astype(np.float32), _jax_params(3))
    (in_sc, out_sc), (jin, jout) = _scalers(rng)
    in_sc = scalers.Scaler(*(a.float() for a in in_sc))
    jin = jscalers.Scaler(*(a.astype(jnp.float32) for a in jin))
    pol = fnn.make_policy(interop.fnn_params_from_numpy(params, device="cpu"),
                          in_sc, out_sc)
    xm = rng.randn(8, 5) * [0.05, 0.4, 1e7, 1e7, 0.1]
    ref = rng.uniform(-0.9, 0.9, 8)
    got = pol(torch.from_numpy(xm), torch.from_numpy(ref), None)
    assert got.dtype == torch.float64
    jpol = jfnn.make_policy(params, jin, jout)
    want = [float(jpol(jnp.asarray(xm[i]), ref[i], 0.0)) for i in range(8)]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-15)


def test_torch_fnn_init_is_seeded():
    """init draws from a torch.Generator (non-parity): Xavier-normal
    weights of the JAX layout, zero biases, repeatable for one seed."""
    a, meta = fnn.init(torch.Generator().manual_seed(0), width_dim=2,
                       dtype=torch.float64, device="cpu")
    b, _ = fnn.init(torch.Generator().manual_seed(0), width_dim=2,
                    dtype=torch.float64, device="cpu")
    assert meta == {"width_dim": 2}
    assert {k: tuple(v.shape) for k, v in a.items()} == {
        k: tuple(np.shape(v)) for k, v in _jax_params(0).items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.all(a["b_in"] == 0) and torch.all(a["b_int"] == 0)
    assert abs(a["w_int"].std().item() - np.sqrt(2.0 / 100)) < 0.02
    sim, _ = fnn.init_simulator(torch.Generator().manual_seed(0), 5, 16, 4,
                                bias=True, device="cpu")
    assert sorted(sim) == ["b_in", "b_int", "b_out", "w_in", "w_int",
                           "w_out"]
    assert torch.all(sim["w_in"].abs() <= 1 / np.sqrt(5))


def _imitation_data(seed, n):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, 3))
    y = np.tanh(1.5 * x[:, :1] - 0.7 * x[:, 1:2] * x[:, 2:3]) \
        + 0.02 * rng.randn(n, 1)
    return x, y


@pytest.mark.parametrize("width_dim", [1, 2])
def test_torch_train_supervised_matches_jax(width_dim):
    """3 epochs on 300 rows, batch 64 (the trailing 300 mod 64 rows of each
    epoch dropped), with the JAX package's initial weights and batch
    tables: losses and final weights to 1e-8."""
    params = _jax_params(11, width_dim)
    xt, yt = _imitation_data(1, 300)
    xv, yv = _imitation_data(2, 80)
    epochs, bs = 3, 64
    want_p, want = jtrain.train_supervised(
        jax.tree.map(jnp.asarray, params), xt, yt, xv, yv,
        width_dim=width_dim, epochs=epochs, batch_size=bs, seed=5)
    perms = [np.asarray(jtrain._epoch_perm(k, len(xt), bs))
             for k in jax.random.split(jax.random.PRNGKey(5), epochs)]
    assert perms[0].shape == (4, 64)

    seen = []
    got_p, rep = train.train_supervised(
        interop.fnn_params_from_numpy(params, device="cpu"), xt, yt, xv, yv,
        width_dim=width_dim, epochs=epochs, batch_size=bs, perms=perms,
        log_fn=lambda *a: seen.append(a))
    np.testing.assert_allclose(rep.train_losses, want.train_losses,
                               rtol=1e-8)
    np.testing.assert_allclose(rep.val_losses, want.val_losses, rtol=1e-8)
    assert [s[0] for s in seen] == [0, 1, 2]
    assert rep.train_losses[-1] < rep.train_losses[0]
    got = interop.fnn_params_to_numpy(got_p)
    for k, w in want_p.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=1e-8,
                                   atol=1e-8)
    assert not any(v.requires_grad for v in got_p.values())


def test_torch_train_supervised_own_perms_repeat():
    """Without perms the batch tables come from a seeded torch.Generator;
    the input params are left as they were."""
    params = interop.fnn_params_from_numpy(_jax_params(2), device="cpu")
    before = {k: v.clone() for k, v in params.items()}
    xt, yt = _imitation_data(3, 100)
    runs = [train.train_supervised(params, xt, yt, xt, yt, epochs=2,
                                   batch_size=32, seed=4)[1]
            for _ in range(2)]
    assert runs[0].train_losses == runs[1].train_losses
    assert all(torch.equal(params[k], before[k]) for k in params)


def test_torch_closed_loop_val_matches_jax():
    """The validation rollout on the JAX package's sample_references draw
    (noise free): the same tracking MAE to 1e-10; without refs the port
    draws its own streams from a seeded generator."""
    rng = np.random.RandomState(4)
    params = _jax_params(4)
    (in_sc, out_sc), (jin, jout) = _scalers(rng)
    jval = jtrain.make_closed_loop_val(jin, jout, n_traj=3, t_traj=20,
                                       dtype=jnp.float64, seed=2,
                                       ref_variant="supervised")
    want = float(jval(jax.tree.map(jnp.asarray, params)))
    refs = np.asarray(jstreams.sample_references(
        jax.random.PRNGKey(2 + 9000), 3, "supervised", 20,
        dtype=jnp.float64))
    val = train.make_closed_loop_val(in_sc, out_sc, n_traj=3, t_traj=20,
                                     dtype=torch.float64, seed=2,
                                     ref_variant="supervised", refs=refs,
                                     device="cpu")
    p = interop.fnn_params_from_numpy(params, device="cpu")
    np.testing.assert_allclose(float(val(p)), want, rtol=1e-10)
    own = train.make_closed_loop_val(in_sc, out_sc, n_traj=3, t_traj=5,
                                     dtype=torch.float64, seed=2,
                                     process_std=(0.0, 1e-3, 1e4, 1e4, 0.0),
                                     device="cpu")
    assert float(own(p)) == float(own(p)) and np.isfinite(float(own(p)))


_TIES = {
    "maximum": (lambda x: ad.maximum(x, 0.0), lambda x: jnp.maximum(x, 0.0)),
    "maximum_lhs": (lambda x: ad.maximum(0.0, x),
                    lambda x: jnp.maximum(0.0, x)),
    "minimum": (lambda x: ad.minimum(x, 0.0), lambda x: jnp.minimum(x, 0.0)),
    "clip": (lambda x: ad.clip(x, -1.0, 1.0),
             lambda x: jnp.clip(x, -1.0, 1.0)),
    "abs": (ad.abs, jnp.abs),
    "pair": (lambda x: ad.maximum(x, x * 1.0), lambda x: jnp.maximum(x, x)),
}


@pytest.mark.parametrize("name", sorted(_TIES))
def test_torch_dual_reverse_mode_ties_match_jax(name):
    """Reverse mode through the plain-tensor helpers takes JAX's value at
    ties (the two sides of a maximum/minimum one half each, abs +1 at 0),
    not torch's (clamp_min passes the whole gradient, abs 0), and the
    forward values equal torch's own ops bitwise."""
    fn, jfn = _TIES[name]
    for x0 in (0.0, -0.0, 1.0, -1.0, 0.5, -2.0):
        x = torch.tensor(x0, dtype=torch.float64, requires_grad=True)
        y = fn(x)
        g, = torch.autograd.grad(y, x)
        assert g.item() == float(jax.grad(jfn)(x0)), (name, x0)
        with torch.no_grad():
            assert torch.equal(y.detach(), fn(x.detach())), (name, x0)
            assert y.item() == float(jfn(x0)), (name, x0)


def test_torch_fnn_hardtanh_bounds_grad_matches_jax():
    """fnn's Hardtanh at exactly +-1 (and inside): the gradient with respect
    to every weight equals jax.grad's (one half at the bounds)."""
    params = _jax_params(0, hidden_dim=4)
    params = {k: np.zeros_like(v) for k, v in params.items()}
    params["w_in"][0, 0], params["w_in"][1, 1] = 1.0, 1.0
    params["w_out"][0, 0], params["w_out"][1, 0] = 1.0, 0.5
    x = np.array([[1.0, 0.0, 0.0], [0.0, 1.5, 0.0], [-1.0, 2.0, 0.0],
                  [0.5, 0.5, 0.0]])      # outputs 1, 0.75, 1, 0.75

    def jloss(p):
        return jnp.sum(jfnn.apply(p, jnp.asarray(x), 1) * jnp.arange(1, 5)[
            :, None])

    want = jax.grad(jloss)(params)
    p = {k: v.requires_grad_(True) for k, v in
         interop.fnn_params_from_numpy(params, device="cpu").items()}
    out = fnn.apply(p, torch.from_numpy(x))
    assert out[:, 0].tolist() == [1.0, 0.75, 1.0, 0.75]
    loss = (out * torch.arange(1, 5, dtype=torch.float64)[:, None]).sum()
    grads = torch.autograd.grad(loss, list(p.values()), allow_unused=True)
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        np.testing.assert_array_equal(g.numpy(), np.asarray(want[k]),
                                      err_msg=k)


def test_torch_make_policy_uncached_grad_matches_jax():
    """Through a 3-step closed loop from X0_REFERENCE (y_dot and z exactly
    0), the gradient of the tracking cost with respect to the controller's
    weights equals jax.grad of the JAX package's, when the policy reads the
    live weights (cache=False); the cached policy cuts it."""
    from forging_control_tpu.loop import closed_loop as jcl
    from forging_control_tpu_torch.loop import closed_loop as cl

    rng = np.random.RandomState(6)
    params = _jax_params(6, hidden_dim=16)
    (in_sc, out_sc), (jin, jout) = _scalers(rng)
    refs = np.array([[0.3, 0.3, 0.3], [-0.2, -0.2, -0.2]])
    loop = dict(t_steps=3, variant="smooth",
                state_clip=(1.0, 10.0, 1e9, 1e9, 1.0))
    x0 = np.tile(np.asarray(jcl.press.X0_REFERENCE), (2, 1))

    def jcost(p):
        ctrl = jcl.FunctionController(jfnn.make_policy(p, jin, jout))
        _, tel = jcl.run_batch(jcl.LoopConfig(**loop), ctrl, jnp.asarray(x0),
                               jnp.asarray(refs), jax.random.PRNGKey(0))
        return jnp.mean(jnp.square(tel.x[..., 1] - tel.ref))

    want = jax.grad(jcost)(params)
    p = {k: v.requires_grad_(True) for k, v in
         interop.fnn_params_from_numpy(params, device="cpu").items()}

    def cost(cache):
        ctrl = cl.FunctionController(fnn.make_policy(p, in_sc, out_sc,
                                                     cache=cache))
        _, tel = cl.run_batch(cl.LoopConfig(**loop), ctrl,
                              torch.from_numpy(x0), torch.from_numpy(refs),
                              device="cpu")
        return torch.mean(torch.square(tel.x[..., 1] - tel.ref))

    grads = torch.autograd.grad(cost(False), list(p.values()),
                                allow_unused=True)
    for (k, v), g in zip(p.items(), grads):
        g = torch.zeros_like(v) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-9, atol=1e-13, err_msg=k)
    assert not cost(True).requires_grad
