"""Import and device hygiene of the port.

* No file of ``src/repro_torch``, ``chip_smoke.py`` or the port's examples
  imports JAX or the reference package (an AST scan).
* Importing the port leaves ``jax`` and ``repro`` out of ``sys.modules``.
* Without a card, the entry points (``python -m repro_torch.obs smoke``
  and ``python -m repro_torch.analysis`` too) refuse to run unless
  ``device="cpu"`` is asked for.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
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
    ROOT / "examples" / "torch_elastic_lasso.py",
    ROOT / "examples" / "torch_attack_smoke.py",
    ROOT / "examples" / "torch_gate_cost.py",
    ROOT / "examples" / "torch_dist_cola.py",
    ROOT / "examples" / "torch_nccl_probe.py",
    ROOT / "examples" / "torch_train_lm_gossip.py",
    ROOT / "examples" / "torch_serve_batched.py"]


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
            "import repro_torch.core.quant, repro_torch.core.schedule, "
            "repro_torch.core.streams; import repro_torch.attack; "
            "import repro_torch.launch.train, repro_torch.optim.gossip, "
            "repro_torch.optim.privacy, repro_torch.train.checkpoint; "
            "import repro_torch.topo, repro_torch.dist; "
            "import repro_torch.obs, repro_torch.obs.cli; "
            "import repro_torch.analysis.drivers, "
            "repro_torch.analysis.selftest, repro_torch.analysis.__main__, "
            "repro_torch.launch.op_analysis; "
            "import repro_torch.launch.dryrun, repro_torch.launch.mesh, "
            "repro_torch.launch.specs; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    # restored after the test: the smoke command points the registry at
    # its --dir
    monkeypatch.setenv("REPRO_RUNS_DIR", "off")
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

    # the obs CLI's smoke runs: on the card unless --device cpu is asked
    from repro_torch.obs import cli as obs_cli, report as obs_report
    with pytest.raises(RuntimeError, match="device='cpu'"):
        obs_cli.main(["--dir", str(tmp_path), "smoke"])
    assert obs_report.load_reports(str(tmp_path)) == []
    assert obs_cli.main(["--dir", str(tmp_path), "smoke", "--device",
                         "cpu"]) == 0
    assert len(obs_report.load_reports(str(tmp_path))) == 2

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

    from repro_torch.launch import train as train_mod
    from repro_torch.optim import gossip
    from repro_torch.train import steps
    from repro_torch.train.data import TokenBatches
    hp = steps.TrainHParams()
    pipe = TokenBatches(cfg.vocab_size, 1, 8, corpus_tokens=1 << 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", "qwen3_4b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", "qwen3_4b", "--smoke", "--steps", "1",
                        "--gossip", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        steps.init_train_state(cfg, None, hp)
    gcfg = gossip.GossipConfig(num_nodes=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.train(cfg, hp, pipe, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.gossip_train(cfg, hp, pipe, gcfg, 1)
    res = train_mod.gossip_train(cfg, hp, pipe, gcfg, 1, device="cpu")
    assert res.states.params["embed"].device.type == "cpu"
    assert res.states.params["embed"].shape[0] == 2


def test_analysis_cli_refuses_without_a_card():
    """``python -m repro_torch.analysis`` runs its drivers on the card
    unless ``--device cpu`` is given; ``--list`` needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.analysis import __main__ as analysis_cli
    for argv in (["--selftest"], ["--all"], ["--driver", "sim"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            analysis_cli.main(argv)
    assert analysis_cli.main(["--list"]) == 0
    assert analysis_cli.main(["--driver", "sim", "--device", "cpu"]) == 0
