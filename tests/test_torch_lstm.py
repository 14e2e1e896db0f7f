"""The port's LSTM surrogate forward (kernel B2) and the toolchain probe
(kernel B3).

On the CPU: the plain version and the module against the JAX package's
``nn.lstm.apply`` (float64, full width) and its Pallas kernel in interpret
mode (float32, the bound of tests/test_ops.py), gradients against
``jax.grad``, the dispatcher and the wrappers' checks.  The kernels
themselves are held against these plain versions on a card by
tests/test_torch_kernels_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from forging_control_tpu.nn import lstm as jlstm
from forging_control_tpu.ops import lstm_pallas
from forging_control_tpu_torch import interop
from forging_control_tpu_torch.nn import lstm
from forging_control_tpu_torch.ops import lstm as lstm_ops
from forging_control_tpu_torch.ops import probe


def _jax_params(seed, *, hidden_dim=50, num_layers=3, dtype=jnp.float64,
                readout_bias=True):
    p = jlstm.init(jax.random.PRNGKey(seed), hidden_dim=hidden_dim,
                   num_layers=num_layers, dtype=dtype,
                   readout_bias=readout_bias)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("readout_bias", [True, False])
def test_torch_lstm_plain_matches_jax_apply(readout_bias):
    """Full width (I = 5, H = 50, L = 3, T = 10), B = 37, float64: the same
    recurrence as JAX's, so equal to rounding (1e-12)."""
    params = _jax_params(0, readout_bias=readout_bias)
    x = np.random.RandomState(1).randn(37, 10, 5)
    want = np.asarray(jlstm.apply(params, jnp.asarray(x)))
    model = interop.lstm_params_from_numpy(params, device="cpu")
    assert (model.b_out is not None) == readout_bias
    xt = torch.from_numpy(x)
    got = lstm_ops.lstm_forward_torch(xt, *model.weights())
    assert got.shape == (37, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-12,
                               atol=1e-12)
    # The module's autograd forward is the plain version; infer on the CPU
    # takes it too.
    assert torch.equal(model(xt), got)
    assert torch.equal(model.infer(xt), got)


@pytest.mark.parametrize("readout_bias", [True, False])
def test_torch_lstm_plain_matches_pallas_interpret(readout_bias):
    """Against the TPU kernel itself in interpret mode at a small width,
    with a batch (37) that is not a multiple of its block (16); float32 and
    the bound of test_ops.py."""
    params = _jax_params(2, hidden_dim=16, num_layers=2, dtype=jnp.float32,
                         readout_bias=readout_bias)
    x = np.random.RandomState(3).randn(37, 6, 5).astype(np.float32)
    want = np.asarray(lstm_pallas.apply_pallas(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), block_b=16,
        interpret=True))
    model = interop.lstm_params_from_numpy(params, device="cpu")
    assert model.w_out.dtype == torch.float32
    got = model.infer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_torch_lstm_gradients_match_jax():
    """Training differentiates the module's forward: gradients of an MSE
    loss equal jax.grad's to rounding."""
    params = _jax_params(4, hidden_dim=8, num_layers=2)
    rng = np.random.RandomState(5)
    x, y = rng.randn(16, 10, 5), rng.randn(16, 4)

    def loss(p):
        return jnp.mean((jlstm.apply(p, jnp.asarray(x)) - y) ** 2)
    want = jax.grad(loss)(jax.tree.map(jnp.asarray, params))
    model = interop.lstm_params_from_numpy(params, device="cpu")
    torch.mean((model(torch.from_numpy(x)) - torch.from_numpy(y)) ** 2) \
        .backward()
    pairs = [(model.w_out.grad, want["w_out"]),
             (model.b_out.grad, want["b_out"])]
    for l, layer in enumerate(want["layers"]):
        pairs += [(model.w_ih[l].grad, layer["w_ih"]),
                  (model.w_hh[l].grad, layer["w_hh"])]
    for got, w in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-10,
                                   atol=1e-13)


def test_torch_lstm_init_layout_and_generator():
    gen = torch.Generator().manual_seed(0)
    model = lstm.init(gen, hidden_dim=8, num_layers=2, dtype=torch.float64,
                      device="cpu")
    assert [tuple(w.shape) for w in model.w_ih] == [(5, 32), (8, 32)]
    assert [tuple(w.shape) for w in model.w_hh] == [(8, 32), (8, 32)]
    assert tuple(model.w_out.shape) == (8, 4)
    assert tuple(model.b_out.shape) == (4,)
    bound = 1 / np.sqrt(8)
    assert all(p.abs().max() <= bound for p in model.parameters())
    again = lstm.init(torch.Generator().manual_seed(0), hidden_dim=8,
                      num_layers=2, dtype=torch.float64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                  again.parameters()))
    nobias = lstm.init(gen, hidden_dim=8, num_layers=2, readout_bias=False,
                       device="cpu")
    assert nobias.b_out is None and nobias.w_out.dtype == torch.float32
    assert len(list(nobias.parameters())) == 5


def test_torch_lstm_dispatch_on_cpu_uses_plain():
    params = _jax_params(6, hidden_dim=8, num_layers=2)
    model = interop.lstm_params_from_numpy(params, device="cpu")
    x = torch.from_numpy(np.random.RandomState(7).randn(2, 3, 10, 5))
    launches = lstm_ops.lstm_forward_cuda.launches
    got = lstm_ops.lstm_forward(x, *model.weights())
    assert got.shape == (2, 3, 4)
    assert torch.equal(got, lstm_ops.lstm_forward_torch(x, *model.weights()))
    single = lstm_ops.lstm_forward(x[0, 0], *model.weights())
    np.testing.assert_allclose(single.detach().numpy(),
                               got[0, 0].detach().numpy(), rtol=1e-14,
                               atol=1e-15)
    assert lstm_ops.lstm_forward_cuda.launches == launches
    with pytest.raises(ValueError, match="unsupported device"):
        lstm_ops.lstm_forward(x.to("meta"), *model.weights())


def test_torch_lstm_kernel_wrapper_refuses_grad_and_cpu_tensors():
    params = _jax_params(8, hidden_dim=8, num_layers=2)
    model = interop.lstm_params_from_numpy(params, device="cpu")
    x = torch.from_numpy(np.random.RandomState(9).randn(4, 10, 5))
    with pytest.raises(RuntimeError, match="backward"):
        lstm_ops.lstm_forward_cuda(x, *model.weights())
    detached = [[w.detach() for w in model.w_ih],
                [w.detach() for w in model.w_hh], model.w_out.detach(),
                model.b_out.detach()]
    with pytest.raises(ValueError, match="CUDA"):
        lstm_ops.lstm_forward_cuda(x, *detached)
    with pytest.raises(RuntimeError, match="backward"):
        lstm_ops.lstm_forward_cuda(x.requires_grad_(), *detached)


def test_torch_probe_plain_and_wrapper_checks():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    assert torch.equal(probe.probe_torch(x), x * 2 + 1)
    with pytest.raises(ValueError, match="CUDA"):
        probe.probe_cuda(x)
