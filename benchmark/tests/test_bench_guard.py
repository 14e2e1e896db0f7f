"""No module under benchmark/ imports JAX or the JAX package, and the
plain reference imports nothing of the program under test.  Names are
compared by their top-level part, whole: ``forging_control_tpu_torch``
begins with ``forging_control_tpu`` and is not it."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "forging_control_tpu"}


def _top_names(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_import(path):
    assert not _top_names(path) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert "forging_control_tpu_torch" not in _top_names(path), path


def test_top_name_is_compared_whole(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import forging_control_tpu_torch.loop\n"
                 "from forging_control_tpu.ops import x\n")
    assert _top_names(p) & FORBIDDEN == {"forging_control_tpu"}
