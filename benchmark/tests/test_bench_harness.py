"""The harness on the CPU: the traffic draw, the end-to-end arithmetic on
made-up timings, the K5 work count, the result line, every cell end to end
at a tiny size through the port's plain paths, and a cell added by files
alone."""

import functools
import hashlib
import json
import shutil
import time
import types
from pathlib import Path

import pytest
import torch

from benchmark import check, harness, traffic as tr
from benchmark.drivers import batched, program, stepper
from benchmark.reference import loop as ref_loop
from benchmark.reference import physics as ph
from benchmark.spans import Spans
from benchmark.work import k5

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny(cfg, traffic):
    """A cell at a size the CPU runs in seconds."""
    cfg["t_steps"] = 4
    traffic["batch"] = 4 if traffic["driver"] == "batched" else 1
    traffic["check"]["rows"] = 4


def _files(name):
    _, cfg, traffic, _ = harness.cell(ROOT, BENCH, name)
    return cfg, traffic


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_traffic_repeats_for_a_seed_and_differs_across_seeds(seed):
    cfg, traffic = _files("ilqr_n10-datagen")
    traffic["batch"] = 16
    a = tr.draw(traffic, cfg, seed, 3, "cpu")
    b = tr.draw(traffic, cfg, seed, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for other in (tr.draw(traffic, cfg, seed + 1, 3, "cpu"),
                  tr.draw(traffic, cfg, seed, 4, "cpu")):
        assert not torch.equal(a[0], other[0])
        assert not torch.equal(a[1], other[1])
    rows = [5, 0, 9]
    sub = tr.draw(traffic, cfg, seed, 3, "cpu", rows=rows)
    assert torch.equal(sub[0], a[0][rows]) and torch.equal(sub[1], a[1][rows])
    refs, noise = a
    T = cfg["t_steps"]
    assert refs.shape == (16, T) and noise.shape == (16, T, 5)
    work, ret = refs[:, 0], refs[:, -1]
    assert bool(((work >= 0.1) & (work < 0.9)).all())
    assert bool(((ret > -0.9) & (ret <= -0.1)).all())
    assert torch.equal(refs[:, :T // 2], work[:, None].expand(16, T // 2))
    assert torch.equal(refs[:, T // 2:], ret[:, None].expand(16, T - T // 2))
    std = noise.reshape(-1, 5).std(0) / torch.tensor(cfg["process_std"])
    assert bool(((std > 0.9) & (std < 1.1)).all())


def _fake_batched(monkeypatch, cell, call_s, stall_at=None, stall_s=0.0):
    """Replace the program's call by one that takes ``call_s`` seconds (and
    ``stall_s`` more in call ``stall_at``)."""
    calls = []

    def run_batch(cfg, loop_cfg, ctrl, x0, refs, noise, device):
        time.sleep(call_s + (stall_s if len(calls) == stall_at else 0.0))
        calls.append(1)
        B, T = refs.shape
        tel = types.SimpleNamespace(u=torch.zeros(B, T),
                                    x=torch.zeros(B, T, 5))
        return None, tel
    monkeypatch.setattr(program, "run_batch", run_batch)
    return calls


def test_rate_is_all_work_over_all_time(monkeypatch):
    cfg, traffic = _files("ilqr_n10-datagen")
    tiny(cfg, traffic)
    rates = []
    for stall in (None, 2):
        c = batched.Cell(cfg, traffic, 1, torch.device("cpu"), Spans())
        calls = _fake_batched(monkeypatch, c, 0.05, stall, 0.3)
        t0 = time.perf_counter()
        rate = c.window(0.4)["solves_per_s"]
        elapsed = time.perf_counter() - t0
        work = len(calls) * traffic["batch"] * cfg["t_steps"]
        assert c.attempted_failed() == (work, 0)
        # Every solve of every call over the window's whole time, which
        # holds the calls' own time and everything between them.
        assert work / elapsed <= rate <= work / (0.05 * len(calls) + (
            0.3 if stall else 0.0))
        rates.append(rate)
    assert rates[1] < 0.8 * rates[0]


def test_a_stall_moves_the_tail(monkeypatch):
    cfg, traffic = _files("ilqr_n10-realtime")
    tiny(cfg, traffic)
    tails = []
    for stall in (False, True):
        c = stepper.Cell(cfg, traffic, 1, torch.device("cpu"), Spans())
        n = [0]

        def step(carry, ref, process_noise=None):
            n[0] += 1
            time.sleep(0.012 if stall and n[0] % 10 == 0 else 0.002)
            return carry, torch.tensor(0.0)
        c.step, c.carry = step, (torch.zeros(1, 5),)
        c.first = [torch.zeros(1, 5)]
        out = c.window(0.5)
        assert len(c.times) == c.attempted_failed()[0] > 40
        assert out["step_ms_p50"] == pytest.approx(2.0, abs=1.5)
        tails.append(out["step_ms_p95"])
    assert tails[1] > tails[0] + 5.0


@pytest.mark.parametrize("name", CELLS)
def test_check_stretches_start_and_cross_the_reversal(name):
    cfg, traffic = _files(name)
    T = cfg["t_steps"]
    plan = check.stretches(traffic, T)
    assert [p[0] for p in plan] == ["start", "reversal"]
    (_, a0, n0, f0), (_, a1, n1, f1) = plan
    split = T // 2
    assert (a0, f0) == (0, 0) and 0 < n0 <= split
    assert a1 == split and n1 > 0 and a1 + n1 <= T
    assert f1 == max(0, split - 10)
    assert check.periods(traffic, T) == a1 + n1


def test_hot_start_is_the_previous_command_and_cold_is_the_config():
    for name in ("ilqr_n10", "sqp_n10"):
        cfg = json.loads((ROOT / "benchmark" / "configs" / f"{name}.json")
                         .read_text())
        u = torch.tensor([0.01, 0.02], dtype=torch.float64)
        v, lam = ref_loop.start(cfg, u, torch.tensor([False, True]))
        cold_v, cold_lam = ref_loop.solver(cfg).init_state(
            cfg, 2, torch.float64)
        assert torch.equal(v[0], cold_v[0]) and torch.equal(lam, cold_lam)
        assert torch.equal(v[1], torch.full_like(v[1], 0.02 / ph.U_SCALE))


def test_k5_work_hand_count_at_n2():
    cfg, _ = _files("ilqr_n10-datagen")
    cfg = dict(cfg, horizon=2)          # gn 5, al 1, substeps 4, nc 2
    period, period_t = 1 + 4 * (65 + 4 * 124), 1 + 4 * (65 + 4 * 126)
    assert (period, period_t) == (2245, 2277)
    lin = 2 * ((period + 13) + 7 * (period_t + 10)) + 11 + 6 * 8
    blocks = 2 * 2 * 4 * (6 + 1 + 36 + 1 + 6) + 2 * 3 * (6 + 36)
    riccati = 2 * (72 + 12 + 900 + 72 + 13 + 72 + 7 + 37 + 252 + 2)
    forward = 4 * (2 * (period + 13 + 20 + 8) + 11 + 6)
    gn = lin + blocks + riccati + forward + 6
    per_solve = 2 * period + 5 * gn + 2 * 2 * 3
    assert per_solve == 298927
    words = (5 + 1 + 1 + 2 + 2 * 2) + (1 + 2 + 2 * 2 + 8)
    assert k5.count(cfg, 3) == {"ops": 3 * per_solve, "bytes": 3 * words * 4}


def test_physics_counts_are_the_reference_physics():
    from benchmark.reference import ilqr
    x = ph.seed(torch.tensor([[0.01, 0.2, 2e6, 3e6, 0.001, 0.3, 0.4]],
                             dtype=torch.float64))
    assert ph.count(lambda: ph.rhs(x[:5], x[5])) == k5.RHS
    one = ph.count(lambda: ph.rk4(x[:5], x[5] * ph.U_SCALE, 1e-3, 1))
    assert one == tuple(k5.SCALE[i] + k5.RK4_COMBINE[i] + 4 * k5.RHS[i]
                        for i in range(2))
    cfg, _ = _files("ilqr_n10-datagen")
    ref = torch.tensor([0.5], dtype=torch.float64)
    for nc, p_max in ((2, None), (4, 32e6)):
        c = dict(cfg, p_max=p_max)
        lam = torch.zeros(1, nc, dtype=torch.float64)
        assert ph.count(lambda: ilqr._stage_res(
            c, x[:6], x[6], ref, lam, 1e4)) == k5.STAGE_RES[nc]
        assert ph.count(lambda: ilqr._term_res(
            c, x[:6], ref, lam, 1e4)) == k5.TERM_RES[nc]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line(trace):
    out = harness.run("ilqr_n10-datagen", 2 ** 33 + 1, 0.0, trace,
                      time.perf_counter(), device="cpu", patch=tiny)
    keys = ["correct", "attempted", "failed"] + (["breakdown"] if trace
                                                 else []) \
        + ["metrics", "device", "checked"]
    assert list(out) == keys
    assert out["correct"] is True
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, v in out["checked"].items():
        assert v["value"] <= v["limit"], name
    want = harness.entries(BENCH, "per_layer" if trace else "end_to_end",
                           "ilqr_n10-datagen")
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "warmup_s" in out["metrics"]    # no device trace on the CPU
    else:
        assert set(out["metrics"]) == {m["name"] for m in want}
    json.dumps(out)


def test_main_prints_the_line_last(monkeypatch, capsys):
    monkeypatch.setattr(harness, "run", functools.partial(
        harness.run, device="cpu", patch=tiny))
    assert harness.main(["--workload", "ilqr_n10-realtime", "--seed", "7",
                         "--seconds", "0", "--trace", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checked"
    last = err.strip().splitlines()[-len(line["checked"]):]
    for (name, v), text in zip(line["checked"].items(), last):
        assert text == f"{name} {v['value']!r} limit {v['limit']!r}"


def test_main_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert harness.main(["--workload", "ilqr_n10-datagen", "--seed", "1",
                         "--seconds", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "CUDA" in err


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_end_to_end_on_the_cpu(name):
    out = harness.run(name, 2 ** 31 + 5, 0.0, False, time.perf_counter(),
                      device="cpu", patch=tiny)
    assert out["correct"] is True, out["checked"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {
        m["name"] for m in harness.entries(BENCH, "end_to_end", name)}


def _digest(folder: Path) -> dict:
    return {str(p.relative_to(folder)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(folder.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
    traffic = json.loads((b / "traffic" / "datagen.json").read_text())
    traffic.update(name="pairs", batch=2)
    (b / "traffic" / "pairs.json").write_text(json.dumps(traffic))
    (b / "metrics" / "calls_traced.py").write_text(
        "def read(rec):\n"
        "    return sum(s['name'] == 'run_batch' for s in rec['spans'])\n")
    (b / "limits" / "ilqr_n10-pairs.json").write_text(
        (b / "limits" / "ilqr_n10-datagen.json").read_text())
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "ilqr_n10-pairs", "config": "ilqr_n10",
                               "traffic": "pairs", "chips": 1,
                               "why": "two scenarios a call"})
    bench["per_layer"].append({"name": "calls_traced", "unit": "calls",
                               "better": "lower", "source": "program_span",
                               "layer": "loop", "moves": "solves_per_s",
                               "workloads": ["ilqr_n10-pairs"]})
    for m in bench["end_to_end"]:
        if m["name"] == "solves_per_s":
            m["workloads"].append("ilqr_n10-pairs")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    def patch(cfg, traffic):
        assert traffic["batch"] == 2
        tiny(cfg, traffic)
        traffic["batch"] = 2
    out = harness.run("ilqr_n10-pairs", 3, 0.0, True, time.perf_counter(),
                      root=tmp_path, device="cpu", patch=patch)
    assert out["correct"] is True
    assert out["metrics"]["calls_traced"]["value"] >= 3   # warm-up, window,
    after = _digest(b)                                     # twin, traced
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {"traffic/pairs.json",
                                        "metrics/calls_traced.py",
                                        "limits/ilqr_n10-pairs.json"}
