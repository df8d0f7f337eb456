"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port either. Names are compared whole,
by their top-level part: the port's name (``repro_torch``) begins with
the JAX package's (``repro``)."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


MODULES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_and_a_plain_reference(path):
    names = imported(path)
    assert not names & NEVER, f"{path} imports {sorted(names & NEVER)}"
    if "reference" in path.relative_to(BENCH).parts:
        assert "repro_torch" not in names and "colabench" not in names, \
            f"the reference {path} imports the program or the harness"


def test_the_check_compares_whole_names(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import repro.core\nfrom jax import numpy\n")
    good = tmp_path / "good.py"
    good.write_text("import repro_torch\nfrom reprox import y\n")
    assert imported(bad) & NEVER == {"repro", "jax"}
    assert not imported(good) & NEVER
