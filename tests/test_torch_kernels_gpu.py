"""Kernels B1 (small Cholesky solve), B2 (LSTM forward), B3 (toolchain
probe), K4 (the closed loop's plant step), K5 (the whole AL-iLQR solve) and
the SQP's Gauss-Newton build and line search against their plain PyTorch
versions on a card (``gpu`` marker; skips without one).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports jax, so run it
there without the conftest:

    python -m pytest -p no:cacheprovider --noconftest -q tests/test_torch_kernels_gpu.py
"""

import re

import numpy as np
import pytest
import torch

from forging_control_tpu_torch import bench
from forging_control_tpu_torch.loop import closed_loop as cl
from forging_control_tpu_torch.nn import lstm
from forging_control_tpu_torch.ops import build, ilqr, plant, probe, smallchol
from forging_control_tpu_torch.ops import lstm as lstm_ops
from forging_control_tpu_torch.physics import press
from forging_control_tpu_torch.solver import riccati, sqp


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
                launches = build.LAUNCHES.copy()
                got = model.infer(x)
                assert dict(build.LAUNCHES - launches) == {"lstm " + kind: 1}
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
    launches = build.LAUNCHES["probe"]
    assert torch.equal(probe.probe_cuda(x), probe.probe_torch(x))
    assert build.LAUNCHES["probe"] == launches + 1
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

    def b2_launches():
        return build.LAUNCHES["lstm mma"] + build.LAUNCHES["lstm simt"]

    before = b2_launches()
    for a, b in zip(run("cuda"), run("cpu")):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-13)
    assert b2_launches() == before


def _plant_inputs(rng, B, dtype, clip):
    lo = np.array([-0.02, -0.9, -3e6, -3e6, -0.25])
    hi = np.array([0.15, 0.9, 3.5e7, 3.5e7, 0.25])
    x = lo + (hi - lo) * rng.rand(B, 5)
    P = press.DEFAULT_PARAMS
    x[0] = press.X0_REFERENCE                        # the gate, y = 0
    x[1] = (0.03, 0.0, 8e6, 4e6, 0.05)               # the gate's tie
    x[2] = (0.03, 0.2, P.PS - P.eps_q / 2, 4e6, 0.05)  # the orifice's kink
    if clip:
        x[3, 2], x[4, 3] = np.nan, np.inf
    std = np.array([5e-4, 2e-3, 5e4, 5e4, 2e-3])
    out = (x, x + rng.randn(B, 5) * std / 50, rng.uniform(-0.25, 0.25, B),
           rng.randn(B, 5) * std, rng.randn(B, 5) * std / 50)
    return [torch.from_numpy(a).to("cuda", dtype).contiguous() for a in out]


@pytest.mark.gpu
def test_torch_plant_kernel_matches_plain_on_gpu():
    """K4 at both team sizes (G = 4, and G = 1, the one-thread body) vs
    its plain version, bit for bit: float64 and float32, B = 1, 2 and 37, the
    three variants, noise and no noise, the state clip with NaN and inf
    states, the gate and the kink; the wrapper's checks."""
    _need_card()
    rng = np.random.RandomState(7)
    for dtype in (torch.float64, torch.float32):
        for B in (37, 2, 1):
            for variant in ("raw", "smooth", "clamp"):
                for clip in (None, (0.12, 0.6, 3.3e7, 3.3e7, 0.2)):
                    cfg = cl.LoopConfig(variant=variant, state_clip=clip)
                    t = _plant_inputs(rng, max(B, 5), dtype,
                                      clip is not None)
                    t = [a[:B].contiguous() for a in t]
                    for noise in (True, False):
                        if not noise:
                            t[3] = t[4] = None
                        want = plant.plant_step_torch(cfg, *t)
                        for G in plant.TEAMS:
                            got = plant.plant_step_cuda(cfg, *t, team=G)
                            torch.cuda.synchronize()
                            for g, w in zip(got, want):
                                assert torch.isfinite(g).all()
                                assert torch.equal(g, w), (G, dtype, B,
                                                           variant, clip)
    x, xm, u, w, v = _plant_inputs(rng, 8, torch.float64, False)
    cfg = cl.LoopConfig()
    with pytest.raises(ValueError, match="cuda tensors"):
        plant.plant_step_cuda(cfg, x.cpu(), xm.cpu(), u.cpu(), None, None)
    with pytest.raises(TypeError):
        plant.plant_step_cuda(cfg, x.float(), xm, u, w, v)
    with pytest.raises(ValueError, match="contiguous"):
        plant.plant_step_cuda(cfg, x, xm, u, w.t().contiguous().t(), v)
    with pytest.raises(RuntimeError, match="backward"):
        plant.plant_step_cuda(cfg, x, xm, u.requires_grad_(), w, v)
    with pytest.raises(ValueError, match="team"):
        plant.plant_step_cuda(cfg, x, xm, u.detach(), w, v, team=3)


@pytest.mark.gpu
def test_torch_plant_sqrt_matches_sqrtf_on_gpu():
    """K4's branch-free float32 square root equals torch.sqrt (the card's
    sqrtf) bit for bit: every 256th bit pattern, both signs, and the
    special values; NaN where sqrtf gives NaN."""
    _need_card()
    bits = torch.arange(0, 2 ** 32, 256, dtype=torch.int64, device="cuda")
    x = (bits - 2 ** 31).to(torch.int32).view(torch.float32)
    x = torch.cat([x, torch.tensor([0.0, -0.0, np.inf, -np.inf, np.nan,
                                    1e-45, 2.0 ** -101, 2.0 ** -102],
                                   device="cuda")])
    got, want = plant.sqrt_cuda(x), torch.sqrt(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))


@pytest.mark.gpu
def test_torch_ilqr_kernel_matches_plain_on_gpu():
    """K5 (riccati.solve_batch through the kernel) vs the plain AL-iLQR on
    the card from the closed loop's cold start: N = 5 and 10, B = 37 and
    300, p_max None and 32e6, the trace; and N = 30 (6 x 2 rounds), B = 37,
    past the cap of 25 the kernel once had.  Float64 u0, v and lam within
    1e-9 at N = 5 and 10; at N = 30, where the solve may turn rounding into
    other accepted steps, the share of scenarios beyond 1e-9 at most 2
    points above the share where the plain path on the card and on the CPU
    part (the share rule of chip_smoke.py 3c).  Float32 commands within
    1e-4 at N = 5 and 10 (where they are not, the message says which
    scenarios and whether they accepted another step); at N = 30, where
    float32's near ties part single scenarios (two steps whose costs lie
    within float32's rounding), within 1e-4 or else by the same share rule
    at 1e-4: the plain float32 solve on the CPU parts from the float64 one
    on the scenarios where the kernel does.  The wrapper's checks."""
    _need_card()
    rng = np.random.RandomState(8)
    for N, B, p_max, trace in ((5, 37, None, True), (10, 300, 32e6, False),
                               (10, 37, None, False), (30, 37, None, False)):
        if N == 30:
            cfg = riccati.MPCConfig(horizon=N, gn_iters=6, al_iters=2,
                                    variant="smooth", p_max=p_max)
        else:
            cfg = riccati.MPCConfig.fast(horizon=N, gn_iters=5,
                                         variant="smooth", p_max=p_max,
                                         record_trace=trace)
        for dtype in (torch.float64, torch.float32):
            x0 = torch.tensor(press.X0_REFERENCE, dtype=dtype,
                              device="cuda").repeat(B, 1)
            ref = torch.from_numpy(rng.uniform(-0.9, 0.6, B)).to("cuda",
                                                                 dtype)
            up = torch.zeros(B, dtype=dtype, device="cuda")
            nc = 2 if p_max is None else 4
            st = riccati.ILQRState(
                torch.zeros(B, N, dtype=dtype, device="cuda"),
                torch.zeros(B, N, nc, dtype=dtype, device="cuda"))
            uk, sk, dk = riccati.solve_batch(cfg, x0, ref, up, st)
            up_, sp, dp = riccati.solve_batch(cfg, x0, ref, up, st,
                                              solver="plain")
            torch.cuda.synchronize()
            assert torch.isfinite(uk).all()
            if dtype == torch.float64 and N == 30:
                uc, sc, _ = riccati.solve_batch(
                    cfg, x0.cpu(), ref.cpu(), up.cpu(),
                    riccati.ILQRState(st.v.cpu(), st.lam.cpu()))

                def beyond(a, b):
                    return ((a[0].cpu() - b[0].cpu()).abs() > 1e-9) \
                        | ((a[1].v.cpu() - b[1].v.cpu()).abs()
                           > 1e-9).any(1) \
                        | ((a[1].lam.cpu() - b[1].lam.cpu()).abs()
                           > 1e-9).flatten(1).any(1)
                far_k = beyond((uk, sk), (up_, sp)).double().mean()
                far_p = beyond((up_, sp), (uc, sc)).double().mean()
                assert far_k <= far_p + 0.02, (float(far_k), float(far_p))
            elif dtype == torch.float64:
                for a, b in ((uk, up_), (sk.v, sp.v), (sk.lam, sp.lam)):
                    assert (a - b).abs().max() <= 1e-9
                torch.testing.assert_close(dk.obj, dp.obj, rtol=1e-9,
                                           atol=1e-12)
                assert torch.equal(dk.iters, dp.iters)
                if trace:
                    assert dk.trace.shape == (B, cfg.al_iters * cfg.gn_iters,
                                              6)
                    torch.testing.assert_close(dk.trace, dp.trace, rtol=1e-7,
                                               atol=1e-12)
            else:
                du = (uk - up_).abs()
                if N >= 25 and du.max() > 1e-4:
                    uc = riccati.solve_batch(
                        cfg, x0.cpu(), ref.cpu(), up.cpu(),
                        riccati.ILQRState(st.v.cpu(), st.lam.cpu()))[0]
                    far_k = bench.far_share(uk.cpu(), up_.cpu(), 1e-4)
                    far_p = bench.far_share(up_.cpu(), uc, 1e-4)
                    assert far_k <= far_p + 0.02, (
                        f"N={N} B={B}: float32 kernel against plain {far_k:.3f}"
                        f", plain on the card against the CPU {far_p:.3f} of "
                        f"scenarios beyond 1e-4")
                    continue
                flips = (dk.alpha != dp.alpha) if dk.trace is None else \
                    (dk.trace[..., 4] != dp.trace[..., 4]).any(1)
                assert du.max() <= 1e-4, (
                    f"N={N} B={B}: float32 max |du| {float(du.max()):.3e} "
                    f"at scenario {int(du.argmax())}, ref "
                    f"{float(ref[du.argmax()]):.6f}; scenarios beyond 1e-4 "
                    f"{int((du > 1e-4).sum())}, of which accepted another "
                    f"alpha {int((flips & (du > 1e-4)).sum())}; iters "
                    f"kernel {dk.iters[du > 1e-4].tolist()} plain "
                    f"{dp.iters[du > 1e-4].tolist()}")
    over = ilqr.max_horizon(torch.float64) + 1
    v = torch.zeros(4, over, dtype=torch.float64, device="cuda")
    lam = torch.zeros(4, over, 2, dtype=torch.float64, device="cuda")
    x0 = torch.zeros(4, 5, dtype=torch.float64, device="cuda")
    ref = torch.zeros(4, dtype=torch.float64, device="cuda")
    cfg = riccati.MPCConfig(horizon=over)
    kcfg, kcfg5 = riccati.kernel_cfg(cfg, over), riccati.kernel_cfg(cfg, 5)
    with pytest.raises(ValueError, match=f"N <= {over - 1} "):
        ilqr.ilqr_cuda(kcfg, cfg.params, x0, ref, ref, v, lam)
    with pytest.raises(ValueError, match="cuda tensors"):
        ilqr.ilqr_cuda(kcfg5, cfg.params, x0.cpu(), ref.cpu(), ref.cpu(),
                       v[:, :5].cpu(), lam[:, :5].cpu())
    with pytest.raises(TypeError):
        ilqr.ilqr_cuda(kcfg5, cfg.params, x0.float(), ref, ref,
                       v[:, :5].contiguous(), lam[:, :5].contiguous())
    with pytest.raises(ValueError, match="float64 is built for team"):
        ilqr.ilqr_cuda(kcfg5, cfg.params, x0, ref, ref,
                       v[:, :5].contiguous(), lam[:, :5].contiguous(),
                       team=16)
    with pytest.raises(RuntimeError, match="backward"):
        ilqr.ilqr_cuda(kcfg5, cfg.params, x0.requires_grad_(), ref, ref,
                       v[:, :5].contiguous(), lam[:, :5].contiguous())


@pytest.mark.gpu
def test_torch_ilqr_sweep_counter_on_gpu():
    """K5's sweep counter (``ilqr.kernel_sweeps``) on the card: per AL
    round, every iteration up to the first that took no step (step norm 0
    in the trace), over the scenarios; rounds past ``SWEEP_ROUNDS`` in the
    last; read and reset."""
    _need_card()
    rng = np.random.RandomState(10)
    for N, gn, al, B in ((25, 5, 2, 4096), (10, 5, 1, 300), (4, 2, 10, 37)):
        cfg = riccati.MPCConfig(horizon=N, gn_iters=gn, al_iters=al,
                                record_trace=True)
        x0 = torch.tensor(press.X0_REFERENCE, device="cuda").repeat(B, 1)
        ref = torch.from_numpy(rng.uniform(-0.9, 0.9, B)).float().cuda()
        v, lam = (torch.zeros(B, N, device="cuda"),
                  torch.zeros(B, N, 2, device="cuda"))
        ilqr.kernel_sweeps(reset=True)
        out = ilqr.ilqr_cuda(riccati.kernel_cfg(cfg, N), cfg.params, x0,
                             ref, torch.zeros_like(ref), v, lam)
        got = ilqr.kernel_sweeps(reset=True)
        stalled = (out.trace[..., 3] == 0).reshape(B, al, gn).cpu()
        first = torch.where(stalled.any(-1), stalled.int().argmax(-1) + 1,
                            torch.full((B, al), gn)).sum(0).tolist()
        want = first[:ilqr.SWEEP_ROUNDS] + [0] * (ilqr.SWEEP_ROUNDS - al)
        want[-1] += sum(first[ilqr.SWEEP_ROUNDS:])
        assert got == want, (N, gn, al)
        assert ilqr.kernel_sweeps() == [0] * ilqr.SWEEP_ROUNDS


def _ilqr_cold(B, N, seed):
    """A cold start at the reference state, float32, on the card:
    references in [-0.9, 0.9] (both strokes)."""
    ref = torch.from_numpy(np.random.RandomState(seed).uniform(-0.9, 0.9, B))
    x0 = torch.tensor(press.X0_REFERENCE, device="cuda").repeat(B, 1)
    return (x0, ref.float().cuda(), torch.zeros(B, device="cuda"),
            torch.zeros(B, N, device="cuda"),
            torch.zeros(B, N, 2, device="cuda"))


@pytest.mark.gpu
def test_torch_ilqr_team_rule_same_bits_on_gpu():
    """K5 at the team size the rule picks (``ilqr.team_size``: 32 or 16
    where the card holds the batch in one wave, the rollouts then on quads
    of four lanes) gives G = 8's outputs bit for bit: B = 1, 256, 4,096 at
    N = 10 (``fast_5x1``, the trace on) and N = 25 (5 x 2)."""
    _need_card()
    for N in (10, 25):
        cfg = (bench.PRESETS["fast_5x1"](horizon=10, variant="smooth",
                                         record_trace=True) if N == 10
               else riccati.MPCConfig(horizon=25, variant="smooth"))
        kcfg = riccati.kernel_cfg(cfg, N)
        for B in (1, 256, 4096):
            args = _ilqr_cold(B, N, B + N)
            rule = ilqr.team_size(B, N, torch.float32,
                                  ilqr.sm_count(torch.cuda.current_device()))
            assert rule == (8 if B == 4096 else 32)
            got = ilqr.ilqr_cuda(kcfg, cfg.params, *args)
            want = ilqr.ilqr_cuda(kcfg, cfg.params, *args, team=8)
            for f, a, b in zip(ilqr.Solved._fields, got, want):
                assert (a is None and b is None) or torch.equal(a, b), \
                    (N, B, rule, f)


@pytest.mark.gpu
def test_torch_ilqr_team_runs_on_gpu():
    """K5's runs by team size, as the device trace names them
    (``ilqr_kernel<float, G>``), through replayed ``make_stepper`` periods
    (B = 1: G = 32, one run a period) and a batch the rule gives G = 8
    (B = 4,096 at N = 10); the launch count adds one a replay."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    cfg = bench.PRESETS["fast_5x1"](horizon=10, variant="smooth")
    ctrl = cl.MPCController(cfg, backend="ilqr")
    step, carry = cl.make_stepper(cl.LoopConfig(variant="smooth"), ctrl,
                                  generator=torch.Generator(device="cuda"))
    zero = [0.0] * 5
    carry, _ = step(carry, 0.3, process_noise=zero)   # eager, capture
    torch.cuda.synchronize()
    launches = build.LAUNCHES["ilqr"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            carry, u = step(carry, 0.3, process_noise=zero)
        float(u)
        ilqr.ilqr_cuda(riccati.kernel_cfg(cfg, 10), cfg.params,
                       *_ilqr_cold(4096, 10, 3))
        torch.cuda.synchronize()
    assert build.LAUNCHES["ilqr"] == launches + 6
    teams = [int(m.group(1)) for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and (m := re.search(r"ilqr_kernel<float, (\d+)>", e.name()))]
    assert teams == [32] * 5 + [8]


@pytest.mark.gpu
def test_torch_ilqr_builds_without_spills_on_gpu():
    """ptxas on K5's instantiations: float32 G = 16 and 32, which hold the
    rollouts on quads, spill nothing; G = 8 keeps 255 registers and no
    spill."""
    _need_card()
    rows, entry = {}, None
    for line in build.load("ilqr").log.splitlines():
        m = re.search(r"Compiling entry function '\S*ilqr_kernelI([fd])Li"
                      r"(\d+)E", line)
        if m:
            entry = (m.group(1), int(m.group(2)))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            rows[entry] = {"spills": int(m.group(1)) + int(m.group(2))}
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows[entry]["registers"] = int(m.group(1))
            entry = None
    assert rows[("f", 16)]["spills"] == 0 and rows[("f", 32)]["spills"] == 0
    assert rows[("f", 8)] == {"spills": 0, "registers": 255}


@pytest.mark.gpu
def test_torch_sqp_kernels_match_plain_on_gpu():
    """solve_batch through the SQP's build, B1 and search against the plain
    solve on the card from the closed loop's cold start: N = 2, 10 and 12,
    p_max None and 32e6, one and two AL rounds, the trace.  Float64 u0, v
    and lam within 1e-9; float32 commands within 1e-4."""
    _need_card()
    rng = np.random.RandomState(9)
    for cfg, B in ((sqp.MPCConfig.fast(horizon=10, gn_iters=5,
                                       variant="smooth"), 300),
                   (sqp.MPCConfig(horizon=10, gn_iters=3, al_iters=2,
                                  p_max=32e6, variant="smooth",
                                  record_trace=True), 37),
                   (sqp.MPCConfig(horizon=2, step_ladder=(1.0, 0.5, 0.25)),
                    37),
                   (sqp.MPCConfig.fast(horizon=12, variant="clamp"), 37)):
        for dtype in (torch.float64, torch.float32):
            x0 = torch.tensor(press.X0_REFERENCE, dtype=dtype,
                              device="cuda").repeat(B, 1)
            ref = torch.from_numpy(rng.uniform(0.1, 0.9, B)).to("cuda", dtype)
            up = torch.zeros(B, dtype=dtype, device="cuda")
            st = sqp.init_state(cfg, dtype, "cuda")
            st = sqp.SolverState(st.v.expand(B, -1).contiguous(),
                                 st.lam.expand(B, -1).contiguous())
            uk, sk, dk = sqp.solve_batch(cfg, x0, ref, up, st)
            up_, sp, dp = sqp.solve_batch(cfg, x0, ref, up, st,
                                          linsolve="plain")
            torch.cuda.synchronize()
            assert torch.isfinite(uk).all()
            if dtype == torch.float64:
                for a, b in ((uk, up_), (sk.v, sp.v), (sk.lam, sp.lam)):
                    assert (a - b).abs().max() <= 1e-9
                assert torch.equal(dk.iters, dp.iters)
                if cfg.record_trace:
                    torch.testing.assert_close(dk.trace, dp.trace, rtol=1e-7,
                                               atol=1e-9)
            else:
                assert (uk - up_).abs().max() <= 1e-4


@pytest.mark.gpu
def test_torch_sqp_captured_period_launches_on_gpu():
    """One captured closed-loop period of the SQP (fast_5x1, N = 10,
    float32, B = 256) holds a build, B1 and a search a Gauss-Newton
    iteration and K4 once, by the launch count; a traced run of two
    periods runs each build and search (by the trace's kernel names) and
    some tens of device kernels, no dispatched rollout (the tensor code's
    period is some 527,000)."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    cfg = sqp.MPCConfig.fast(horizon=10, gn_iters=5, variant="smooth")
    ctrl = cl.MPCController(cfg)
    loop = cl.LoopConfig(t_steps=2, variant="smooth")
    B = 256
    x0 = torch.tensor(press.X0_REFERENCE, device="cuda").float().repeat(B, 1)
    refs = torch.full((B, 2), 0.4, device="cuda")
    cl.run_batch(loop, ctrl, x0, refs, device="cuda")   # captures
    period = cl.cached_period(loop, ctrl, B, torch.float32, "cuda")
    assert period.stats["launches"] == {
        "smallchol": 5, "plant": 1, "sqp_build": 5, "sqp_search": 5}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cl.run_batch(loop, ctrl, x0, refs, device="cuda")
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert sum("sqp_build_kernel" in n for n in names) == 10
    assert sum("sqp_search_kernel" in n for n in names) == 10
    assert len(names) <= 2 * 60
