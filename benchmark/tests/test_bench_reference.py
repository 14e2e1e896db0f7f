"""The plain reference agrees with the port's float64 plain path on the
CPU, for both controllers: the only place where the benchmark's tests
import the program beside the reference."""

import json
from pathlib import Path

import pytest
import torch
from forging_control_tpu_torch.loop.closed_loop import run_batch

from benchmark.drivers import program
from benchmark.reference import loop as ref_loop

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("config", ["ilqr_n10", "sqp_n10"])
def test_reference_closed_loop_is_the_ports_float64_plain_loop(config):
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / f"{config}.json").read_text())
    B, T = 2, 4
    cfg = dict(cfg, linsolve="plain", t_steps=T)
    f64 = torch.float64
    g = torch.Generator().manual_seed(5)
    work = 0.8 * torch.rand(B, generator=g, dtype=f64) + 0.1
    ret = -(0.8 * torch.rand(B, generator=g, dtype=f64) + 0.1)
    refs = torch.where(torch.arange(T) < T // 2, work[:, None], ret[:, None])
    w = torch.randn(B, T, 5, generator=g, dtype=f64) \
        * torch.tensor(cfg["process_std"], dtype=f64)
    x0 = torch.tensor(cfg["x0"], dtype=f64).repeat(B, 1)
    loop_cfg, ctrl = program.objects(cfg)
    _, tel = run_batch(loop_cfg, ctrl, x0, refs, process_noise=w,
                       device="cpu")
    u, xs = ref_loop.closed_loop(cfg, x0, refs, w)
    assert float((u - tel.u).abs().max()) < 1e-9
    scale = torch.tensor([0.1, 0.1, 1e7, 1e7, 0.01], dtype=f64)
    assert float(((xs - tel.x).abs() / scale).max()) < 1e-9
    # The replay of the program's commands gives its states, and the
    # controller followed on them gives its commands.
    truth = ref_loop.replay(cfg, x0, tel.u, w)
    assert float(((truth[:, 1:] - tel.x).abs() / scale).max()) < 1e-9
    u_prev = torch.cat([torch.zeros(B, 1, dtype=f64), tel.u[:, :-1]], 1)
    followed, _ = ref_loop.follow(cfg, truth[:, :T], refs, u_prev)
    assert float((followed - tel.u).abs().max()) < 1e-9
