"""The port stands alone: it imports without jax and without any module of
the JAX package, and its smoke script refuses to run without a card."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import sys
sys.modules["jax"] = None          # any `import jax` now raises ImportError
import forging_control_tpu_torch
from forging_control_tpu_torch import bench, cli, dual, interop
from forging_control_tpu_torch import __main__
from forging_control_tpu_torch.eval import metrics
from forging_control_tpu_torch.nn import (datasets, lstm, scalers,
                                          surrogate_eval, train)
from forging_control_tpu_torch.ops import build, lstm, probe, smallchol
from forging_control_tpu_torch.pipelines import (config, generate_data,
                                                 surrogate)
from forging_control_tpu_torch.utils import checkpoint
import chip_smoke
loaded = sorted(m for m in sys.modules
                if m == "forging_control_tpu"
                or m.startswith("forging_control_tpu."))
assert not loaded, loaded
assert sys.modules["jax"] is None
print("standalone ok")
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
    return env


def test_torch_port_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "standalone ok" in out.stdout


def test_torch_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA (this test's premise; it skips on a card) and in a
    directory that holds nothing else of the repo, the smoke script exits
    non-zero and prints no result line."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=300)]
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                               cwd=tmp_path, env=env, capture_output=True,
                               text=True, timeout=300))
    for out in runs:
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
