"""Spans that the harness records around its calls into the program.

A span has a name, a start and an end on the host's clock
(``time.perf_counter``, seconds) and the index of the span it lies in.  They
are kept in memory and written out when the run ends.  While a trace is
recorded, each span is also a ``torch.profiler.record_function`` range, so
the trace shows what the host was doing between the device's operations.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path


class Spans:
    def __init__(self):
        self.items: list[dict] = []
        self._open: list[int] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        parent = self._open[-1] if self._open else None
        idx = len(self.items)
        self.items.append({"name": name, "start": time.perf_counter(),
                           "end": None, "parent": parent})
        self._open.append(idx)
        ctx = contextlib.nullcontext()
        if self.profiling:
            import torch
            ctx = torch.profiler.record_function(name)
        try:
            with ctx:
                yield
        finally:
            self._open.pop()
            self.items[idx]["end"] = time.perf_counter()

    def add(self, name: str, start: float, end: float, parent=None) -> int:
        """A span timed by the caller (one whose clock reads it takes
        anyway, such as a control period's); returns its index."""
        self.items.append({"name": name, "start": start, "end": end,
                           "parent": parent})
        return len(self.items) - 1

    def total(self, name: str) -> float:
        return sum(s["end"] - s["start"] for s in self.items
                   if s["name"] == name)

    def write(self, path: Path) -> None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.items))
