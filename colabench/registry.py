"""Where the benchmark finds its parts: by name, in files of their own.

``<root>`` is the benchmark's folder (this one, or a copy of it):

* ``<root>/configs/<config>.json``    a deployment: problem, shape, K, ...
* ``<root>/traffic/<traffic>.json``   how the user drives a solve
* ``<root>/workloads/<cell>.json``    a cell's target, round cap, limits
* ``<root>/metrics/<metric>.py``      ``read(record)``: one metric's reader
* ``<root>/rooflines/<work>.py``      ``cost(...)``: bytes and FLOPs

and ``<root>/../BENCHMARK.json`` binds cells to configurations and traffic
and lists the metrics. Adding a configuration, a traffic mix, a cell or a
metric adds files and entries; no code here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KINDS = {"configs": ".json", "traffic": ".json", "workloads": ".json",
         "metrics": ".py", "rooflines": ".py"}


def bench_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root).parent / "BENCHMARK.json").read_text())


def names(kind: str, root: Path = ROOT) -> list[str]:
    """The names of every part of ``kind`` under ``root``."""
    suffix = KINDS[kind]
    return sorted(p.name[:-len(suffix)] for p in (Path(root) / kind).iterdir()
                  if p.name.endswith(suffix) and not p.name.startswith("_"))


def _path(kind: str, name: str, root: Path) -> Path:
    path = Path(root) / kind / f"{name}{KINDS[kind]}"
    if not path.is_file():
        raise KeyError(f"no {kind[:-1] if kind.endswith('s') else kind} "
                       f"named {name!r} ({path} is missing)")
    return path


def load_json(kind: str, name: str, root: Path = ROOT) -> dict:
    return json.loads(_path(kind, name, root).read_text())


def load_module(kind: str, name: str, root: Path = ROOT):
    """The module of ``<root>/<kind>/<name>.py``, loaded from its file."""
    path = _path(kind, name, root)
    mod_name = f"colabench_{kind}_{name}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell ``name`` with everything it needs: its ``BENCHMARK.json``
    entry, its file, its configuration and its traffic, and the metrics
    it reports (``end_to_end`` and ``per_layer`` entries that list it, or
    list no cells)."""
    spec = bench_spec(root)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    own = load_json("workloads", name, root)
    for key in ("config", "traffic"):
        if own[key] != entry[key]:
            raise ValueError(f"cell {name!r}: {key} is {own[key]!r} in its "
                             f"file and {entry[key]!r} in BENCHMARK.json")
    covers = lambda m: name in m.get("workloads", [name])
    return {"name": name, "entry": entry, "cell": own,
            "config": load_json("configs", entry["config"], root),
            "traffic": load_json("traffic", entry["traffic"], root),
            "end_to_end": [m for m in spec["end_to_end"] if covers(m)],
            "per_layer": [m for m in spec["per_layer"] if covers(m)],
            "root": Path(root)}
