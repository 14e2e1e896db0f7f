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
from forging_control_tpu_torch.ops import build
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
    launches = build.LAUNCHES.copy()
    got = lstm_ops.lstm_forward(x, *model.weights())
    assert got.shape == (2, 3, 4)
    assert torch.equal(got, lstm_ops.lstm_forward_torch(x, *model.weights()))
    single = lstm_ops.lstm_forward(x[0, 0], *model.weights())
    np.testing.assert_allclose(single.detach().numpy(),
                               got[0, 0].detach().numpy(), rtol=1e-14,
                               atol=1e-15)
    assert build.LAUNCHES == launches
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


def _tf32(a):
    """Round float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _lstm_forward_with(x, w_ih, w_hh, w_out, b_out, matmul):
    """lstm_forward_torch with its gate products taken by ``matmul``."""
    H = w_hh[0].shape[0]
    h = [x.new_zeros(x.shape[0], H) for _ in w_hh]
    c = [x.new_zeros(x.shape[0], H) for _ in w_hh]
    for t in range(x.shape[1]):
        inp = x[:, t]
        for l, (wi, wh) in enumerate(zip(w_ih, w_hh)):
            i, f, g, o = (matmul(inp, wi) + matmul(h[l], wh)).split(H, -1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            inp = h[l]
    return h[-1] @ w_out + b_out


def test_torch_lstm_3xtf32_products_meet_the_float32_bound():
    """The accuracy argument of the mma variant of kernel B2, emulated on
    the CPU: with the recorded surrogate (results_repro/surrogate_params.npz)
    at full width on 4,000 random windows, gate products taken as three
    TF32 passes (a_lo b_hi + a_hi b_lo + a_hi b_hi, a_hi = tf32(a),
    a_lo = tf32(a - a_hi), float32 sums; TF32 products are exact in
    float32) stay within the float32 bound of the JAX package, rtol 2e-5 /
    atol 2e-6 against lstm_forward_torch; one TF32 pass does not."""
    from forging_control_tpu_torch.utils import checkpoint
    model, _ = checkpoint.load_surrogate(
        "results_repro/surrogate_params.npz", device="cpu")
    w_ih, w_hh, w_out, b_out = model.weights()
    w = ([a.detach() for a in w_ih], [a.detach() for a in w_hh],
         w_out.detach(), b_out.detach())
    assert w_out.dtype == torch.float32 and tuple(w_out.shape) == (50, 4)
    x = torch.from_numpy(
        np.random.RandomState(0).rand(4000, 10, 5).astype(np.float32))
    want = lstm_ops.lstm_forward_torch(x, *w)

    def one_pass(a, b):
        return _tf32(a) @ _tf32(b)

    def three_pass(a, b):
        a_hi, b_hi = _tf32(a), _tf32(b)
        a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
        return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi

    def excess(got):
        return ((got - want).abs() - (2e-6 + 2e-5 * want.abs())).max().item()
    assert excess(_lstm_forward_with(x, *w, three_pass)) <= 0
    assert excess(_lstm_forward_with(x, *w, one_pass)) > 1e-4


def _one_pass(a, b):
    return _tf32(a) @ _tf32(b)


def _three_pass(a, b):
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _round_to_zero(x):
    """float64 -> float32 (numpy), rounded toward zero, as a tensor core
    rounds the sum of an mma."""
    f = x.astype(np.float32)
    return np.where(np.abs(f) > np.abs(x), np.nextafter(f, np.float32(0)), f)


def _mma_product(acc, a, w, per_kstep):
    """acc + a @ w (numpy float32) as the mma variant of kernel B2 takes it:
    K padded to a multiple of 8, three TF32 passes a k-step (a_lo b_hi,
    a_hi b_lo, a_hi b_hi), each an exact sum of 8 products rounded toward
    zero with the accumulator it adds to; that accumulator is ``acc``
    itself (``per_kstep`` false) or a fresh one per k-step, then added to
    ``acc`` with round to nearest."""
    nk = -(-a.shape[-1] // 8)
    a = np.pad(a, ((0, 0), (0, 8 * nk - a.shape[-1])))
    w = np.pad(w, ((0, 8 * nk - w.shape[0]), (0, 0)))
    a_hi, w_hi = (_tf32(torch.from_numpy(v)).numpy() for v in (a, w))
    a_lo, w_lo = (_tf32(torch.from_numpy(v - h)).numpy()
                  for v, h in ((a, a_hi), (w, w_hi)))
    parts = [np.einsum("bkj,kjn->kbn",
                       x.reshape(len(x), nk, 8).astype(np.float64),
                       y.reshape(nk, 8, -1).astype(np.float64))
             for x, y in ((a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi))]
    for k in range(nk):
        d = np.zeros_like(acc) if per_kstep else acc
        for p in parts:
            d = _round_to_zero(d + p[k])
        acc = (acc.astype(np.float64) + d).astype(np.float32) \
            if per_kstep else d
    return acc


def _lstm_forward_mma(x, w_ih, w_hh, w_out, b_out, per_kstep):
    """The mma variant's recurrence, layer by layer; the hidden product is
    skipped at t = 0, where h is zero."""
    H = w_hh[0].shape[0]
    w_ih, w_hh = [w.numpy() for w in w_ih], [w.numpy() for w in w_hh]
    h = [x.new_zeros(x.shape[0], H) for _ in w_hh]
    c = [x.new_zeros(x.shape[0], H) for _ in w_hh]
    for t in range(x.shape[1]):
        inp = x[:, t]
        for l, (wi, wh) in enumerate(zip(w_ih, w_hh)):
            acc = _mma_product(np.zeros((x.shape[0], 4 * H), np.float32),
                               inp.numpy(), wi, per_kstep)
            if t > 0:
                acc = _mma_product(acc, h[l].numpy(), wh, per_kstep)
            i, f, g, o = torch.from_numpy(acc).split(H, -1)
            c[l] = torch.sigmoid(f) * c[l] + torch.sigmoid(i) * torch.tanh(g)
            h[l] = torch.sigmoid(o) * torch.tanh(c[l])
            inp = h[l]
    return h[-1] @ w_out + b_out


@pytest.fixture(scope="module")
def recorded_drift():
    """chip_smoke.py phase 8a's drift rollout on the CPU: the recorded
    surrogate's weights, the feature track of the recorded unsupervised
    controller's closed loop, and the plain forward's 290 predictions."""
    import chip_smoke
    from forging_control_tpu_torch.pipelines import generate_data
    results = generate_data.load(str(chip_smoke.REPO / chip_smoke.SUP_DATASET))
    _, _, (model, _, track, plain) = chip_smoke.recorded_unsupervised_metrics(
        results, "cpu")
    w_ih, w_hh, w_out, b_out = model.weights()
    w = ([a.detach() for a in w_ih], [a.detach() for a in w_hh],
         w_out.detach(), b_out.detach())
    return model, w, track, plain


@pytest.mark.parametrize("products, sound", [
    ("three TF32 passes, round to nearest", True),
    ("one TF32 pass", False),
    ("mma, one accumulator a gate", False),
    ("mma, a fresh accumulator a k-step", True)])
def test_torch_lstm_mma_drift_within_the_smoke_bound(recorded_drift, products,
                                                     sound):
    """The free-running drift of chip_smoke.py phase 8a (the recorded
    surrogate rolled 290 steps along the recorded unsupervised controller's
    closed loop, one window at a time), on the CPU with kernel B2's gate
    products emulated.  A sound kernel stays within the smoke run's bounds
    of the JAX package's pinned drift metrics (``chip_smoke.DRIFT_TOL``)
    and within check_lstm's float32 bound of the plain rollout at every
    step: three TF32 passes summed with round to nearest, and the mma
    variant as it is, whose tensor cores round each mma's sum toward zero
    into a fresh accumulator per k-step.  One TF32 pass leaves both, and so
    does the mma variant with all 24 mma of a gate chained into one
    accumulator, which met check_lstm's bound in one forward and read the
    R^2 of p1 2.07e-4 off on an H100."""
    import types

    import chip_smoke
    from forging_control_tpu_torch.nn import surrogate_eval as se
    model, w, track, plain = recorded_drift
    forward = {
        "three TF32 passes, round to nearest":
            lambda x: _lstm_forward_with(x, *w, _three_pass),
        "one TF32 pass": lambda x: _lstm_forward_with(x, *w, _one_pass),
        "mma, one accumulator a gate":
            lambda x: _lstm_forward_mma(x, *w, False),
        "mma, a fresh accumulator a k-step":
            lambda x: _lstm_forward_mma(x, *w, True)}[products]
    preds = se.free_running(
        types.SimpleNamespace(w_out=model.w_out, infer=forward), track, 10)
    got = se.fidelity_metrics(preds[:-1], track[11:, :4])
    excess = max(abs(got[k] - v) - chip_smoke.DRIFT_TOL[k.split("_")[0]]
                 for k, v in chip_smoke.RECORDED_UNSUP["drift"].items())
    share = ((preds - plain).abs() / (2e-6 + 2e-5 * plain.abs())).max().item()
    if sound:
        assert excess <= 0 and share <= 1, (excess, share)
    else:
        assert excess > 0 and share > 1, (excess, share)

def test_torch_lstm_kernel_variant_by_shape_and_dtype():
    """The main path's float32 shape (T = 10, I = 5, H = 50) takes the mma
    kernel; float64 and H = 256 the simt kernel; the boundary at T = 10 lies
    between H = 56 and H = 57, where the mma block outgrows shared memory:
    one layer's fragments (14 k-steps x 28 n8 tiles x 64 floats) and the h
    sequence and double buffer (12 x 32 rows x 60 floats), 4 bytes each."""
    f32, f64 = torch.float32, torch.float64
    assert lstm_ops.smem_bytes_mma(10, 5, 50) == 4 * (14 * 28 * 64
                                                      + 12 * 32 * 60)
    assert lstm_ops.smem_bytes_mma(10, 5, 56) <= lstm_ops.MAX_SMEM
    assert lstm_ops.smem_bytes_mma(10, 5, 57) > lstm_ops.MAX_SMEM
    assert lstm_ops.variant(f32, 10, 5, 50) == "mma"
    assert lstm_ops.variant(f32, 10, 5, 56) == "mma"
    assert lstm_ops.variant(f32, 10, 5, 57) == "simt"
    assert lstm_ops.variant(f32, 6, 5, 16) == "mma"
    assert lstm_ops.variant(f64, 10, 5, 50) == "simt"
    assert lstm_ops.variant(f32, 3, 5, 256) == "simt"
    assert lstm_ops.variant(f32, 300, 5, 50) == "simt"     # T too long
    # The edges in T that tests/test_torch_kernels_gpu.py runs on the card.
    assert lstm_ops.variant(f32, 9, 5, 64) == "mma"
    assert lstm_ops.variant(f32, 10, 5, 64) == "simt"
    assert lstm_ops.smem_bytes_mma(148, 5, 8) == lstm_ops.MAX_SMEM
    assert lstm_ops.variant(f32, 148, 5, 8) == "mma"
    assert lstm_ops.variant(f32, 149, 5, 8) == "simt"
