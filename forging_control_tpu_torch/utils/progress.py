"""In-run console progress — the ``alive_progress`` role, zero-dep.

Port of ``forging_control_tpu/utils/progress.py``.  The reference wraps its
epoch/trajectory loops in ``alive_bar`` (``Supervised Learning/
Functions.py:592-600`` region; ``alive_it`` over trajectories in the
closed-loop scripts).  The port's trainers (``nn/train.py``) call a
``log_fn(epoch, train, val)`` hook after each epoch, as the JAX package's
do; :func:`epoch_log_fn` renders it as a single-line ANSI bar with rate
and ETA, degrading to plain line logging when the stream is not a TTY.
"""

from __future__ import annotations

import sys
import time


class ProgressBar:
    """Single-line console bar: ``|█████░░░░| 42/100 [12.3/s, eta 5s] msg``.

    Usage::

        bar = ProgressBar(total=100, label="train")
        for i in range(100):
            ...
            bar.update(msg=f"loss {loss:.4f}")
        bar.close()
    """

    def __init__(self, total: int, label: str = "", width: int = 30,
                 stream=None, min_interval_s: float = 0.05):
        self.total = max(1, int(total))
        self.label = label
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.min_interval_s = min_interval_s
        self.n = 0
        self.t0 = time.perf_counter()
        self._last_render = 0.0
        self._tty = hasattr(self.stream, "isatty") and self.stream.isatty()

    def update(self, k: int = 1, msg: str = ""):
        self.n = min(self.total, self.n + k)
        now = time.perf_counter()
        if (now - self._last_render < self.min_interval_s
                and self.n < self.total):
            return
        self._last_render = now
        elapsed = now - self.t0
        rate = self.n / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.n) / rate if rate > 0 else float("inf")
        if self._tty:
            filled = self.width * self.n // self.total
            bar = "█" * filled + "░" * (self.width - filled)
            line = (f"\r{self.label} |{bar}| {self.n}/{self.total} "
                    f"[{rate:.1f}/s, eta {eta:.0f}s] {msg}")
            # \x1b[K clears to end-of-line so a shorter render never
            # leaves residue from a longer previous one.
            self.stream.write(line[:200] + "\x1b[K")
        else:
            pct = 100 * self.n // self.total
            self.stream.write(
                f"{self.label} {self.n}/{self.total} ({pct}%) "
                f"[{rate:.1f}/s] {msg}\n")
        self.stream.flush()

    def close(self):
        if self._tty:
            self.stream.write("\n")
            self.stream.flush()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def epoch_log_fn(epochs: int, label: str = "train", stream=None):
    """A ``log_fn(epoch, train_loss, val_loss)`` for the trainers
    (nn/train.py) that drives a ProgressBar — drop-in for the reference's
    ``alive_bar`` epoch loop."""
    bar = ProgressBar(total=epochs, label=label, stream=stream)

    def log(epoch, train_loss, val_loss):
        bar.update(msg=f"loss {float(train_loss):.5f} "
                       f"val {float(val_loss):.5f}")
        if epoch + 1 >= epochs:
            bar.close()

    return log
