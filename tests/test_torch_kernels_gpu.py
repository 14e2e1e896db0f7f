"""Kernels B2 (LSTM forward) and B3 (toolchain probe) against their plain
PyTorch versions on a card (``gpu`` marker; skips without one).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch; ``tests/conftest.py`` imports jax, so run it
there without the conftest:

    python -m pytest -p no:cacheprovider --noconftest -q tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from forging_control_tpu_torch.nn import lstm
from forging_control_tpu_torch.ops import lstm as lstm_ops
from forging_control_tpu_torch.ops import probe


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU or interpret "
                    "mode (their plain versions are tested on the CPU)")


@pytest.mark.gpu
def test_torch_lstm_kernel_matches_plain_on_gpu():
    """float32 (the JAX package's bound for apply_pallas, rtol 2e-5 / atol
    2e-6) and float64 (1e-12); full width and small widths, ragged batches,
    no readout bias; one launch per ``infer``."""
    _need_card()
    from forging_control_tpu_torch.device import resolve_device
    resolve_device("cuda")                      # TF32 off for the plain @
    gen = torch.Generator().manual_seed(0)
    for dtype, rtol, atol in ((torch.float32, 2e-5, 2e-6),
                              (torch.float64, 1e-12, 1e-12)):
        for H, L, T, bias in ((50, 3, 10, True), (50, 3, 10, False),
                              (16, 2, 6, True), (256, 2, 3, True)):
            model = lstm.init(gen, 5, H, L, 4, dtype=dtype, device="cuda",
                              readout_bias=bias)
            for B in (1, 37, 300, 2053):
                x = torch.randn(B, T, 5, generator=gen,
                                dtype=torch.float64).to("cuda", dtype)
                launches = lstm_ops.lstm_forward_cuda.launches
                got = model.infer(x)
                assert lstm_ops.lstm_forward_cuda.launches == launches + 1
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
