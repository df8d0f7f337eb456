"""A configuration, a traffic mix, a cell and a metric are added as new
files (and entries in BENCHMARK.json) in a copy of the benchmark: the
harness lists and loads all of them, and runs the new cell, while no file
that was there changes."""
from __future__ import annotations

import hashlib
import json

from colabench import harness, registry


def digests(root) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_add_by_files(tiny_root):
    before = digests(tiny_root)
    cfg = json.loads((tiny_root / "configs" / "lasso_epsilon_k16.json")
                     .read_text())
    cfg.update(name="lasso_epsilon_k8", nodes=8)
    (tiny_root / "configs" / "lasso_epsilon_k8.json").write_text(
        json.dumps(cfg))
    (tiny_root / "traffic" / "gap4_b32.json").write_text(json.dumps(
        {"recorder": "gap", "record_every": 4, "block_size": 32,
         "wire": "fp32"}))
    (tiny_root / "workloads" / "lasso_eps8.gap.json").write_text(json.dumps(
        {"config": "lasso_epsilon_k8", "traffic": "gap4_b32", "eps": 1e-2,
         "max_rounds": 400,
         "limits": {"x_err": 1e-5, "v_err": 1e-5, "hist_err": 1e-5,
                    "stop_shift": 0}}))
    (tiny_root / "metrics" / "stop_rounds.py").write_text(
        "def read(record):\n"
        "    return sum(s['stop_round'] for s in record['solves'])"
        " / len(record['solves'])\n")
    spec_path = tiny_root.parent / "BENCHMARK.json"
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "lasso_epsilon_k8", "source": "test",
                            "file": "colabench/configs/lasso_epsilon_k8.json",
                            "reduced": ["nodes"], "why": "test"})
    spec["workloads"].append({"name": "lasso_eps8.gap",
                              "config": "lasso_epsilon_k8",
                              "traffic": "gap4_b32", "chips": 1,
                              "why": "test"})
    spec["end_to_end"].append({"name": "stop_rounds", "unit": "rounds",
                               "better": "lower", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["lasso_eps8.gap"]})
    spec_path.write_text(json.dumps(spec))

    assert "lasso_epsilon_k8" in registry.names("configs", tiny_root)
    assert "gap4_b32" in registry.names("traffic", tiny_root)
    assert "lasso_eps8.gap" in registry.names("workloads", tiny_root)
    assert "stop_rounds" in registry.names("metrics", tiny_root)
    c = registry.cell("lasso_eps8.gap", tiny_root)
    assert c["config"]["nodes"] == 8
    assert [m["name"] for m in c["end_to_end"]] == ["solve_s", "setup_s",
                                                    "stop_rounds"]
    # an existing cell does not report the new cell's metric
    assert "stop_rounds" not in [m["name"] for m in registry.cell(
        "lasso_eps16.solve", tiny_root)["end_to_end"]]

    result = harness.run("lasso_eps8.gap", 2 ** 31 + 11, 0.2, False,
                         root=tiny_root, device="cpu")
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"solve_s", "setup_s", "stop_rounds"}
    assert result["metrics"]["stop_rounds"]["value"] > 0
    after = digests(tiny_root)
    assert {k: after[k] for k in before} == before
