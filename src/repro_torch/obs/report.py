"""Run registry: RunReport records appended as JSONL under ``.repro_runs/``.

The port's copy of the reference registry (``repro.obs.report``), the same
schema and file, so either package's ``obs`` CLI reads the other's runs.
Every telemetry run (``ColaConfig.telemetry=True``) emits one ``RunReport``
— config + content-addressed problem fingerprint, the plan contract line,
counter totals, span timings and a history summary plus compact per-round
series — appended to ``<runs dir>/runs.jsonl``. The directory defaults to
``.repro_runs`` under the CWD; the ``REPRO_RUNS_DIR`` env var overrides it
(tests point it at a tmpdir), and setting it to ``0``/``off`` disables
auto-emission entirely.

``diff_reports`` separates what changed into config / counters / history
deltas: two runs differing only in ``telemetry`` itself (the bitwise-twin
check) diff to an empty history delta and a config delta touching only
telemetry fields.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any

DEFAULT_DIR = ".repro_runs"
ENV_DIR = "REPRO_RUNS_DIR"
#: retention cap on registry lines; ``REPRO_RUNS_KEEP`` overrides (0 or a
#: negative value disables pruning entirely)
ENV_KEEP = "REPRO_RUNS_KEEP"
DEFAULT_KEEP = 200

#: report fields that describe telemetry itself, not the computation — the
#: diff classifier (and the bitwise-twin acceptance check) keys off this
TELEMETRY_FIELDS = ("counters", "spans", "series", "run_id", "timestamp")
#: config knobs that only toggle observation, never the math
TELEMETRY_CONFIG_KEYS = ("telemetry",)


def runs_dir(path: str | None = None) -> str:
    return path or os.environ.get(ENV_DIR) or DEFAULT_DIR


def runs_file(path: str | None = None) -> str:
    return os.path.join(runs_dir(path), "runs.jsonl")


def pruned_file(path: str | None = None) -> str:
    """Sidecar holding the cumulative count of retention-pruned lines."""
    return os.path.join(runs_dir(path), "runs.pruned")


def pruned_total(dir: str | None = None) -> int:
    """How many registry lines retention has dropped over this registry's
    lifetime (what ``obs list`` surfaces so pruning is never silent)."""
    try:
        with open(pruned_file(dir)) as f:
            return int(f.read().strip() or 0)
    except (FileNotFoundError, ValueError):
        return 0


@dataclasses.dataclass
class RunReport:
    """One run's record (the JSONL line, 1:1 with ``to_dict``)."""

    run_id: str
    timestamp: float
    driver: str                 # run_cola | run_dist_cola | gossip | ...
    problem: str                # executor.fingerprint of the Problem
    config: dict                # dataclasses.asdict of the run config
    graph: dict                 # {"kind", "num_nodes"}
    rounds: int                 # rounds executed
    contract: str | None        # plan contract line (counter byte budget)
    history: dict               # summary: final row values, stop_round, ...
    counters: dict | None       # obs.counters.summarize totals
    spans: dict | None          # obs.trace Tracer.summary()
    series: dict | None         # compact per-round series for `timeline`

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "RunReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: d.get(k) for k in known})


def _history_summary(history: dict) -> dict:
    final: dict = {}
    for key, val in history.items():
        if key in ("telemetry", "round") or not isinstance(val, list):
            continue
        if val:
            final[key] = float(val[-1])
    return {"rounds_recorded": len(history.get("round", [])),
            "final": final,
            "stop_round": history.get("stop_round"),
            "certificate_violated": history.get("certificate_violated")}


def _series(history: dict, telemetry: dict | None) -> dict:
    out: dict = {}
    if history.get("round"):
        out["round"] = [int(t) for t in history["round"]]
        for key in ("gap", "primal", "consensus", "dp_epsilon"):
            if isinstance(history.get(key), list) and history[key]:
                out[key] = [float(v) for v in history[key]]
    if telemetry and isinstance(telemetry.get("series"), dict):
        out.update(telemetry["series"])
    return out


def make_report(*, driver: str, problem_fp: str, config: dict, graph: dict,
                rounds: int, history: dict, contract: str | None = None,
                counters: dict | None = None,
                spans: dict | None = None) -> RunReport:
    telemetry = history.get("telemetry")
    if counters is None and isinstance(telemetry, dict):
        counters = {k: v for k, v in telemetry.items() if k != "series"}
    body = {"driver": driver, "problem": problem_fp, "config": config,
            "graph": graph, "rounds": rounds}
    ts = time.time()
    run_id = hashlib.sha256(
        (json.dumps(body, sort_keys=True, default=str)
         + repr(ts)).encode()).hexdigest()[:12]
    return RunReport(run_id=run_id, timestamp=ts, contract=contract,
                     history=_history_summary(history),
                     counters=counters, spans=spans,
                     series=_series(history, telemetry), **body)


def retention_limit(keep: int | None = None) -> int:
    """Registry line cap (``REPRO_RUNS_KEEP``, default ``DEFAULT_KEEP``);
    ``<= 0`` means unbounded."""
    if keep is not None:
        return keep
    raw = os.environ.get(ENV_KEEP, "")
    try:
        return int(raw) if raw else DEFAULT_KEEP
    except ValueError:
        raise ValueError(
            f"{ENV_KEEP}={raw!r} is not an integer (want a line cap, "
            "or <= 0 to disable registry pruning)")


def prune_registry(dir: str | None = None, *,
                   keep: int | None = None) -> int:
    """Drop the OLDEST registry lines past the retention cap.

    Returns how many lines were pruned (0 when under the cap or pruning is
    disabled). Appending is the hot path, so the rewrite only happens on
    the appends that actually overflow; order is preserved, which keeps
    ``find_report`` index references stable for the surviving tail.
    """
    limit = retention_limit(keep)
    if limit <= 0:
        return 0
    path = runs_file(dir)
    if not os.path.exists(path):
        return 0
    with open(path) as f:
        lines = [ln for ln in f if ln.strip()]
    excess = len(lines) - limit
    if excess <= 0:
        return 0
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.writelines(lines[excess:])
    os.replace(tmp, path)
    total = pruned_total(dir) + excess
    with open(pruned_file(dir), "w") as f:
        f.write(str(total))
    return excess


def append_report(report: RunReport | dict, dir: str | None = None, *,
                  keep: int | None = None) -> str:
    """Append one report line to the registry; returns the JSONL path.

    Enforces the retention cap (``REPRO_RUNS_KEEP``, default
    ``DEFAULT_KEEP`` lines) by pruning oldest-first after the append, so
    an always-on telemetry fleet cannot grow the JSONL without bound."""
    d = runs_dir(dir)
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "runs.jsonl")
    rec = report.to_dict() if isinstance(report, RunReport) else report
    with open(path, "a") as f:
        f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
    prune_registry(dir, keep=keep)
    return path


def auto_emit(report: RunReport, dir: str | None = None) -> str | None:
    """Registry append for telemetry runs; disabled when ``REPRO_RUNS_DIR``
    is set to ``0``/``off``/``none``."""
    env = os.environ.get(ENV_DIR, "")
    if dir is None and env.lower() in ("0", "off", "none"):
        return None
    return append_report(report, dir)


def load_reports(dir: str | None = None) -> list:
    path = runs_file(dir)
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def find_report(ref: str, reports: list) -> dict:
    """Resolve a CLI run reference: a run_id prefix, or a 0-based index
    (negative counts from the end: ``-1`` is the latest run)."""
    try:
        return reports[int(ref)]
    except (ValueError, IndexError):
        pass
    hits = [r for r in reports if str(r.get("run_id", "")).startswith(ref)]
    if len(hits) == 1:
        return hits[0]
    if not hits:
        raise KeyError(f"no run matching {ref!r} "
                       f"({len(reports)} runs in registry)")
    raise KeyError(f"ambiguous run reference {ref!r}: "
                   + ", ".join(r["run_id"] for r in hits))


def _delta(a: dict | None, b: dict | None, *, skip: tuple = ()) -> dict:
    a, b = a or {}, b or {}
    out = {}
    for key in sorted(set(a) | set(b)):
        if key in skip:
            continue
        va, vb = a.get(key), b.get(key)
        if va != vb:
            out[key] = (va, vb)
    return out


def diff_reports(a: dict, b: dict) -> dict:
    """Structured delta between two report records.

    ``only_telemetry`` is True when the runs computed the same thing — the
    history summary matches exactly and every differing config knob is a
    telemetry toggle — i.e. observation changed, the math did not.
    """
    cfg = _delta(a.get("config"), b.get("config"))
    hist = _delta((a.get("history") or {}).get("final"),
                  (b.get("history") or {}).get("final"))
    counters = _delta(a.get("counters"), b.get("counters"),
                      skip=("series",))
    stop = ((a.get("history") or {}).get("stop_round"),
            (b.get("history") or {}).get("stop_round"))
    return {
        "runs": (a.get("run_id"), b.get("run_id")),
        "config": cfg,
        "history": hist,
        "counters": counters,
        "rounds": (a.get("rounds"), b.get("rounds")),
        "stop_round": stop,
        "only_telemetry": (not hist and stop[0] == stop[1]
                           and a.get("rounds") == b.get("rounds")
                           and set(cfg) <= set(TELEMETRY_CONFIG_KEYS)),
    }
