"""warmup_s: seconds of the harness's warm-up call (span "warmup"): the
program's first, eager period, the capture and the instantiation of the
cell's CUDA graph, synchronised."""


def read(rec):
    spans = [s for s in rec["spans"] if s["name"] == "warmup"]
    return sum(s["end"] - s["start"] for s in spans) if spans else None
