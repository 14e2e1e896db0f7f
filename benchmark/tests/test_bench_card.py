"""On the card: every cell end to end through the harness for a short
window, correct, with its metrics (``python -m pytest benchmark/tests -m
gpu`` on a machine with a card; skips elsewhere)."""

import time

import pytest

from benchmark import harness

from .test_bench_harness import BENCH, CELLS


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_every_cell_on_the_card(card, name):
    out = harness.run(name, 2 ** 31 + 977, 2.0, False, time.perf_counter())
    assert out["correct"] is True, out["checked"]
    assert out["device"]["platform"] == "gpu"
    assert set(out["metrics"]) == {
        m["name"] for m in harness.entries(BENCH, "end_to_end", name)}
