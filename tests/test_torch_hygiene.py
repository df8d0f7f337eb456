"""Import and device hygiene of the port.

* No file of ``src/repro_torch``, ``chip_smoke.py`` or the port's examples
  imports JAX or the reference package (an AST scan).
* Importing the port leaves ``jax`` and ``repro`` out of ``sys.modules``.
* Without a card, the entry points refuse to run unless ``device="cpu"``
  is asked for.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_elastic_lasso.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0 and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_and_reference_unloaded():
    code = ("import sys, repro_torch; repro_torch.run_cola; "
            "from repro_torch.kernels import ops; import repro_torch.convert; "
            "import repro_torch.launch.serve; "
            "import repro_torch.core.baselines; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import PROBLEMS, convert, run_cola
    from repro_torch.core import topology
    x = np.ones((6, 4), np.float32)
    y = np.ones((6,), np.float32)
    for name, make in PROBLEMS.items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(x, y, 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(x, x, device=None)
    prob = PROBLEMS["ridge_primal"](x, y, 0.1, device="cpu")
    from repro_torch.core.cola import ColaConfig
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cola(prob, topology.ring(2), ColaConfig(), 2)
    res = run_cola(prob, topology.ring(2), ColaConfig(), 2, device="cpu")
    assert res.state.x_parts.device.type == "cpu"

    from repro_torch.core import baselines
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.make_consensus_problem(x, y, 2, loss="square", reg="l2",
                                         lam=0.1)
    cons = baselines.make_consensus_problem(x, y, 2, loss="square",
                                            reg="l2", lam=0.1, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        baselines.run_dgd(cons, topology.ring(2), step=0.1, rounds=2)
    res = baselines.run_dgd(cons, topology.ring(2), step=0.1, rounds=2,
                            device="cpu")
    assert res.w_stack.device.type == "cpu"

    from repro_torch import build_model, get_config, smoke_variant
    from repro_torch.launch import serve
    cfg = smoke_variant(get_config("qwen3_4b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    api = build_model(cfg, device="cpu")
    params = api.init(torch.Generator().manual_seed(0))
    prompt = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.serve(api, params, prompt, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen3_4b", "--smoke"])
    res = serve.serve(api, params, prompt, 2, device="cpu")
    assert res.logits.device.type == "cpu"
