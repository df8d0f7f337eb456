"""Fixtures of the benchmark's own tests (``python -m pytest -q
colabench/tests`` from the root of the repository).

``tiny_root`` copies the benchmark into a temporary directory beside a
copy of ``BENCHMARK.json``, with every configuration cut to a size the
CPU runs in a second and every cell's target and round cap set for it;
the limits stay the cells' own. Tests that need the card carry the
``card`` marker and take the ``cuda`` fixture, which skips where there is
no card.
"""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# (problem) -> sizes that keep a whole solve under a second on the CPU
TINY = {"lasso": {"n_samples": 800, "n_features": 64, "nodes": 4},
        "ridge_dual": {"n_samples": 256, "n_features": 32, "nodes": 4}}
# (problem) -> a target the tiny problem reaches in some tens of rounds
TINY_EPS = {"lasso": 1.0, "ridge_dual": 0.05}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: this test runs on the card")
    return "cuda"


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    """A copy of the benchmark at tiny sizes; returns its folder."""
    root = tmp_path / "colabench"
    shutil.copytree(REPO / "colabench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    problems = {}
    for path in (root / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY[cfg["problem"]])
        problems[path.stem] = cfg["problem"]
        path.write_text(json.dumps(cfg))
    for path in (root / "workloads").glob("*.json"):
        cell = json.loads(path.read_text())
        cell.update(eps=TINY_EPS[problems[cell["config"]]], max_rounds=400)
        path.write_text(json.dumps(cell))
    return root
