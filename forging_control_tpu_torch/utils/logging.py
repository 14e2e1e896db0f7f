"""Dual console + file logging.

Port of ``forging_control_tpu/utils/logging.py``: the equivalent of the
reference's per-module logging setup (``Supervised Learning/
Functions.py:53-64``) without its last-importer-wins ``mode='w'`` bug, one
idempotent configurator for the package logger.  The console handler is a
``logging.StreamHandler()``, so what the package logs (the CLI's result
line among it) goes to standard error, as in the JAX package.  The logger
propagates to the root logger.
"""

from __future__ import annotations

import logging


def get_logger(name: str = "forging_control_tpu_torch",
               log_file: str | None = None,
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(message)s"))
        logger.addHandler(sh)
    if log_file and not any(
            isinstance(h, logging.FileHandler) and
            getattr(h, "baseFilename", None) == log_file
            for h in logger.handlers):
        fh = logging.FileHandler(log_file, mode="a")
        fh.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
    return logger
