"""Kernels B1 (small Cholesky solve), B2 (LSTM forward) and B3 (toolchain
probe) against their plain PyTorch versions on a card (``gpu`` marker;
skips without one).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports jax, so run it
there without the conftest:

    python -m pytest -p no:cacheprovider --noconftest -q tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from forging_control_tpu_torch.nn import lstm
from forging_control_tpu_torch.ops import lstm as lstm_ops
from forging_control_tpu_torch.ops import probe, smallchol


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret "
                    "mode (their plain versions are tested on the CPU)")


def _random_spd(rng, B, N):
    A = rng.randn(B, N, N)
    H = A @ np.transpose(A, (0, 2, 1)) + N * np.eye(N)
    g = rng.randn(B, N)
    return H, g


@pytest.mark.gpu
def test_torch_chol_kernel_matches_plain_on_gpu():
    """CUDA kernel vs plain version on the card, float32 and float64,
    N in {1, 5, 10, 17, 21, 25} (N >= 17 spilled in the first design),
    batches below one block of 32 systems and not a multiple of it, views
    at an offset that is not 16-byte aligned; the wrapper's checks."""
    _need_card()
    rng = np.random.RandomState(5)
    for dtype, rtol in ((torch.float32, 1e-4), (torch.float64, 1e-12)):
        for N in (1, 5, 10, 17, 21, 25):
            for B in (1, 33, 127, 300, 12288):
                H, g = _random_spd(rng, B, N)
                Ht = torch.from_numpy(H).to("cuda", dtype)
                gt = torch.from_numpy(g).to("cuda", dtype)
                got = smallchol.chol_solve_cuda(Ht, gt)
                want = smallchol.chol_solve_torch(Ht, gt)
                torch.cuda.synchronize()
                # H = AA^T + N I has condition number below ~10: the two
                # differ by rounding only.
                torch.testing.assert_close(got, want, rtol=rtol,
                                           atol=rtol * want.abs().max().item())
        # Contiguous views at an offset that is not a multiple of 16 bytes
        # (odd N): the kernel stages them element by element.
        for N in (5, 25):
            H, g = _random_spd(rng, 301, N)
            Ht = torch.from_numpy(H).to("cuda", dtype)[1:]
            gt = torch.from_numpy(g).to("cuda", dtype)[1:]
            assert Ht.is_contiguous() and Ht.data_ptr() % 16 != 0
            assert gt.data_ptr() % 16 != 0
            got = smallchol.chol_solve_cuda(Ht, gt)
            want = smallchol.chol_solve_torch(Ht, gt)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=rtol,
                                       atol=rtol * want.abs().max().item())
    Ht = torch.from_numpy(H).cuda()
    gt = torch.from_numpy(g).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        smallchol.chol_solve_cuda(Ht.transpose(1, 2), gt)
    with pytest.raises(TypeError):
        smallchol.chol_solve_cuda(Ht.half(), gt.half())
    with pytest.raises(ValueError, match="N <= 25"):
        smallchol.chol_solve_cuda(torch.eye(26, device="cuda")[None],
                                  torch.ones(1, 26, device="cuda"))
    with pytest.raises(RuntimeError, match="backward"):
        smallchol.chol_solve_cuda(Ht.requires_grad_(), gt)


@pytest.mark.gpu
def test_torch_lstm_kernel_matches_plain_on_gpu():
    """float32 (the JAX package's bound for apply_pallas, rtol 2e-5 / atol
    2e-6) and float64 (1e-12); full width and small widths, ragged batches,
    no readout bias, both sides of the boundary between the mma and simt
    variants in H (56 and 57 at T = 10) and in T (9 and 10 at H = 64; 148
    and 149 at H = 8, where the mma block takes exactly 232448 bytes), so
    that the shapes ``lstm_ops.variant`` sends to the mma kernel at its
    edges launch there; one launch per ``infer``, of the variant that
    ``lstm_ops.variant`` names."""
    _need_card()
    from forging_control_tpu_torch.device import resolve_device
    resolve_device("cuda")                      # TF32 off for the plain @
    gen = torch.Generator().manual_seed(0)
    for dtype, rtol, atol in ((torch.float32, 2e-5, 2e-6),
                              (torch.float64, 1e-12, 1e-12)):
        for H, L, T, bias in ((50, 3, 10, True), (50, 3, 10, False),
                              (16, 2, 6, True), (256, 2, 3, True),
                              (56, 3, 10, True), (57, 3, 10, True),
                              (64, 2, 9, True), (64, 2, 10, True),
                              (8, 2, 148, True), (8, 2, 149, True)):
            model = lstm.init(gen, 5, H, L, 4, dtype=dtype, device="cuda",
                              readout_bias=bias)
            kind = lstm_ops.variant(dtype, T, 5, H)
            for B in (1, 37, 300, 2053):
                x = torch.randn(B, T, 5, generator=gen,
                                dtype=torch.float64).to("cuda", dtype)
                launches = lstm_ops.lstm_forward_cuda.launches
                by_kind = lstm_ops.lstm_forward_cuda.variant_launches[kind]
                got = model.infer(x)
                assert lstm_ops.lstm_forward_cuda.launches == launches + 1
                assert (lstm_ops.lstm_forward_cuda.variant_launches[kind]
                        == by_kind + 1)
                want = model(x).detach()
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.gpu
def test_torch_lstm_kernel_wrapper_checks_on_gpu():
    _need_card()
    model = lstm.init(torch.Generator().manual_seed(1), hidden_dim=8,
                      num_layers=2, device="cuda")
    w_ih, w_hh, w_out, b_out = model.weights()
    w = ([a.detach() for a in w_ih], [a.detach() for a in w_hh],
         w_out.detach(), b_out.detach())
    x = torch.randn(6, 10, 5, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        lstm_ops.lstm_forward_cuda(x.transpose(0, 1).contiguous()
                                   .transpose(0, 1), *w)
    with pytest.raises(TypeError):
        lstm_ops.lstm_forward_cuda(x.double(), *w)
    with pytest.raises(ValueError, match="shapes"):
        lstm_ops.lstm_forward_cuda(x[..., :4].contiguous(), *w)
    with pytest.raises(RuntimeError, match="backward"):
        lstm_ops.lstm_forward_cuda(x, w_ih, w_hh, w_out, b_out)
    big = lstm.init(torch.Generator().manual_seed(2), hidden_dim=257,
                    num_layers=1, device="cuda")
    with pytest.raises(ValueError, match="H <= 256"):
        big.infer(x)


@pytest.mark.gpu
def test_torch_probe_kernel_matches_plain_on_gpu():
    _need_card()
    x = torch.arange(8 * 128, dtype=torch.float32,
                     device="cuda").reshape(8, 128)
    launches = probe.probe_cuda.launches
    assert torch.equal(probe.probe_cuda(x), probe.probe_torch(x))
    assert probe.probe_cuda.launches == launches + 1
    assert probe.main() == 0


@pytest.mark.gpu
def test_torch_feasibility_and_recorded_controller_on_gpu():
    """Feasibility recovery on the card in float64 against the CPU (the
    same arithmetic up to rounding; a near tie in the projection's discrete
    decisions may move a command by one late Gauss-Newton step, so 1e-7),
    and the recorded FNN controller loaded onto the card: its policy there
    equals the CPU's to float32 rounding."""
    _need_card()
    from pathlib import Path

    from forging_control_tpu_torch.nn import fnn
    from forging_control_tpu_torch.physics import press
    from forging_control_tpu_torch.solver import feasibility as feas
    from forging_control_tpu_torch.utils import checkpoint

    rng = np.random.RandomState(0)
    B = 64
    x = np.stack([rng.uniform(0, 0.1, B), rng.uniform(-0.6, 0.6, B),
                  rng.uniform(-5e5, 3.3e7, B), rng.uniform(1e5, 3.3e7, B),
                  rng.uniform(-0.2, 0.2, B)], -1)
    x[0] = (0.08, 0.15, 2e5, 9e6, 0.05)
    u = rng.uniform(-0.3, 0.3, B)
    cfg = feas.FeasibilityConfig()
    xt, ut = torch.from_numpy(x), torch.from_numpy(u)
    cpu = feas.recover(cfg, ut, xt)
    card = feas.recover(cfg, ut.cuda(), xt.cuda())
    assert card.u.device.type == "cuda"
    torch.testing.assert_close(card.u.cpu(), cpu.u, rtol=0, atol=1e-7)
    warm = feas.init_warm(cfg, B, torch.float64, "cuda")
    res, new = feas.recover_warm(cfg, ut.cuda(), xt.cuda(), warm)
    res_c, _ = feas.recover_warm(cfg, ut, xt, feas.init_warm(
        cfg, B, torch.float64, "cpu"))
    torch.testing.assert_close(res.u.cpu(), res_c.u, rtol=0, atol=1e-7)
    assert new.lam.device.type == "cuda"

    path = Path(__file__).resolve().parents[1] / "results_repro" / \
        "results" / "NN_controller_N_10_process_noise.npz"
    params, in_sc, out_sc, meta = checkpoint.load_controller(str(path),
                                                             device="cuda")
    assert all(v.device.type == "cuda" and v.is_contiguous()
               for v in params.values())
    p_cpu, _, _, _ = checkpoint.load_controller(str(path), device="cpu")
    xm = torch.tensor(press.X0_REFERENCE).repeat(4, 1).float()
    ref = torch.tensor([0.5, 0.2, -0.3, -0.6])
    got = fnn.make_policy(params, in_sc, out_sc)(xm.cuda(), ref.cuda(), None)
    want = fnn.make_policy(p_cpu, in_sc, out_sc)(xm, ref, None)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_torch_mpc_loss_on_gpu_matches_cpu():
    """The MPC loss (N = 10, noise drawn once on the CPU) and its gradient
    with respect to the controller: card float64 against CPU float64,
    rtol 1e-10; it runs the plain LSTM forward, which kernel B2 does not
    replace (B2 has no backward), so no kernel launches."""
    _need_card()
    from forging_control_tpu_torch.nn import fnn, mpc_loss

    gen = torch.Generator().manual_seed(0)
    model = lstm.init(gen, dtype=torch.float64, device="cpu")
    params, _ = fnn.init(gen, dtype=torch.float64, device="cpu")
    x = torch.rand(15, 3, generator=gen, dtype=torch.float64) - 0.5
    win = torch.rand(15, 10, 5, generator=gen, dtype=torch.float64) - 0.5
    noise = torch.randn(10, 15, 4, generator=gen, dtype=torch.float64)

    def run(device):
        p = {k: v.to(device).requires_grad_(True) for k, v in params.items()}
        m = lstm.LSTMSurrogate(*[
            [w.detach().to(device) for w in ws] if isinstance(ws, list)
            else None if ws is None else ws.detach().to(device)
            for ws in model.weights()])
        xd = x.to(device)
        loss, out = mpc_loss.mpc_loss(p, m, xd, fnn.apply(p, xd),
                                      win.to(device), horizon=10,
                                      noise=noise)
        grads = torch.autograd.grad(loss, [p["w_in"], p["w_out"]])
        return [t.detach().cpu() for t in (loss, out.prediction, *grads)]

    before = lstm_ops.lstm_forward_cuda.launches
    for a, b in zip(run("cuda"), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-13)
    assert lstm_ops.lstm_forward_cuda.launches == before
