"""``python -m repro_torch.obs`` — query the run registry.

Subcommands:
  list                 one line per recorded run
  show RUN             full report (RUN = run_id prefix or index, -1 = last)
  diff RUN_A RUN_B     config / counter / history deltas between two runs
  timeline RUN         per-round ASCII timeline (gap / eps / saturation)
  smoke [--device D]   run two tiny telemetry runs (clean + attacked int8)
                       on D (default cuda; ``--device cpu`` asks for the
                       CPU) and exercise list/show/diff/timeline on them
"""
from __future__ import annotations

import argparse
import datetime
import json
import math
from typing import Any

from repro_torch.obs import report as report_lib

_BLOCKS = " ▁▂▃▄▅▆▇█"


def sparkline(values, width: int = 64, log: bool = False) -> str:
    """Resample ``values`` to ``width`` buckets (max within bucket) and
    render one block character per bucket."""
    vals = [float(v) for v in values if v is not None]
    if not vals:
        return ""
    if log:
        floor = min((v for v in vals if v > 0), default=1e-12)
        vals = [math.log10(max(v, floor)) for v in vals]
    n = len(vals)
    width = min(width, n)
    buckets = [max(vals[i * n // width:(i + 1) * n // width] or [vals[-1]])
               for i in range(width)]
    lo, hi = min(buckets), max(buckets)
    span = hi - lo or 1.0
    return "".join(_BLOCKS[round((b - lo) / span * (len(_BLOCKS) - 1))]
                   for b in buckets)


def _fmt_ts(ts) -> str:
    try:
        return datetime.datetime.fromtimestamp(float(ts)).strftime(
            "%Y-%m-%d %H:%M:%S")
    except (TypeError, ValueError):
        return "?"


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def cmd_list(args) -> int:
    reports = report_lib.load_reports(args.dir)
    pruned = report_lib.pruned_total(args.dir)
    if not reports:
        print(f"no runs in {report_lib.runs_file(args.dir)}")
        if pruned:
            print(f"({pruned} older run(s) pruned by retention; "
                  f"cap={report_lib.retention_limit()}, "
                  f"override with {report_lib.ENV_KEEP})")
        return 0
    print(f"{'#':>3} {'run_id':<12} {'when':<19} {'driver':<13} "
          f"{'K':>3} {'rounds':>6} {'stop':>5} {'final':<22}")
    for i, r in enumerate(reports):
        hist = r.get("history") or {}
        final = hist.get("final") or {}
        lead = next(iter(
            f"{k}={_fmt(v)}" for k, v in final.items()), "")
        stop = hist.get("stop_round")
        print(f"{i:>3} {str(r.get('run_id', '?')):<12} "
              f"{_fmt_ts(r.get('timestamp')):<19} "
              f"{str(r.get('driver', '?')):<13} "
              f"{(r.get('graph') or {}).get('num_nodes', '?'):>3} "
              f"{r.get('rounds', '?'):>6} "
              f"{'-' if stop is None else stop:>5} {lead:<22}")
    if pruned:
        print(f"({pruned} older run(s) pruned by retention; "
              f"cap={report_lib.retention_limit()}, "
              f"override with {report_lib.ENV_KEEP})")
    return 0


def cmd_show(args) -> int:
    reports = report_lib.load_reports(args.dir)
    rec = report_lib.find_report(args.run, reports)
    rec = dict(rec)
    if not args.series:
        rec.pop("series", None)
        if isinstance(rec.get("counters"), dict):
            rec["counters"] = {k: v for k, v in rec["counters"].items()
                               if k != "series"}
    print(json.dumps(rec, indent=2, sort_keys=True, default=str))
    return 0


def cmd_diff(args) -> int:
    reports = report_lib.load_reports(args.dir)
    a = report_lib.find_report(args.run_a, reports)
    b = report_lib.find_report(args.run_b, reports)
    d = report_lib.diff_reports(a, b)
    print(f"diff {d['runs'][0]} -> {d['runs'][1]}")
    for section in ("config", "history", "counters"):
        delta = d[section]
        if not delta:
            print(f"  {section}: (no change)")
            continue
        print(f"  {section}:")
        for key, (va, vb) in delta.items():
            print(f"    {key}: {_fmt(va)} -> {_fmt(vb)}")
    print(f"  rounds: {d['rounds'][0]} -> {d['rounds'][1]}   "
          f"stop_round: {d['stop_round'][0]} -> {d['stop_round'][1]}")
    print(f"  only_telemetry: {d['only_telemetry']}")
    return 0


def cmd_timeline(args) -> int:
    reports = report_lib.load_reports(args.dir)
    rec = report_lib.find_report(args.run, reports)
    series = rec.get("series") or {}
    rounds = series.get("round")
    print(f"timeline {rec.get('run_id')} ({rec.get('driver')}, "
          f"{rec.get('rounds')} rounds)")
    if rounds:
        print(f"  recorded rounds {rounds[0]}..{rounds[-1]} "
              f"({len(rounds)} rows)")
    shown = False
    rows = (("gap", True), ("primal", False), ("dp_epsilon", False),
            ("saturation", False), ("ef_norm", True), ("gate", False))
    for key, log in rows:
        vals = series.get(key)
        if not vals:
            continue
        line = sparkline(vals, width=args.width, log=log)
        lo, hi = min(map(float, vals)), max(map(float, vals))
        tag = " (log)" if log else ""
        print(f"  {key:<11} |{line}| min={_fmt(lo)} max={_fmt(hi)}{tag}")
        shown = True
    if not shown:
        print("  (no per-round series in this report — run with "
              "ColaConfig(telemetry=True))")
    return 0


def cmd_smoke(args) -> int:
    """Two tiny telemetry runs + every subcommand over them (CI smoke). The
    runs take ``args.device``: the card unless the CPU is asked for."""
    import os

    from repro_torch import attack, convert, topo as topo_programs
    from repro_torch.core.cola import ColaConfig, run_cola
    from repro_torch.data import synthetic
    from repro_torch.device import resolve

    dev = resolve(args.device)
    if args.dir:
        os.environ[report_lib.ENV_DIR] = args.dir
    x, y, _ = synthetic.regression(120, 48, seed=1)
    prob = convert.problem_from_numpy("lasso", x, y, 1e-3, device=dev)
    graph = topo_programs.build("torus2d", 16)
    rounds = 24
    atk = [attack.Byzantine(nodes=(1, 6), mode="sign_flip", scale=10.0,
                            start=4)]
    run_cola(prob, graph, ColaConfig(telemetry=True), rounds, device=dev)
    run_cola(prob, graph,
             ColaConfig(telemetry=True, wire="int8", robust="trim"),
             rounds, attacks=atk, device=dev)
    print(f"smoke: 2 telemetry runs on {dev} appended to "
          f"{report_lib.runs_file(args.dir)}\n")
    ns = argparse.Namespace(dir=args.dir)
    cmd_list(ns)
    print()
    cmd_show(argparse.Namespace(dir=args.dir, run="-1", series=False))
    print()
    cmd_diff(argparse.Namespace(dir=args.dir, run_a="-2", run_b="-1"))
    print()
    cmd_timeline(argparse.Namespace(dir=args.dir, run="-1", width=48))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="query the .repro_runs run registry")
    ap.add_argument("--dir", default=None,
                    help="registry directory (default .repro_runs or "
                         "$REPRO_RUNS_DIR)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="one line per recorded run")
    p = sub.add_parser("show", help="full report record")
    p.add_argument("run", help="run_id prefix or index (-1 = latest)")
    p.add_argument("--series", action="store_true",
                   help="include the per-round series arrays")
    p = sub.add_parser("diff", help="delta between two runs")
    p.add_argument("run_a")
    p.add_argument("run_b")
    p = sub.add_parser("timeline", help="per-round ASCII timeline")
    p.add_argument("run")
    p.add_argument("--width", type=int, default=64)
    p = sub.add_parser("smoke", help="2 tiny telemetry runs + all subcommands")
    p.add_argument("--device", default="cuda",
                   help="where the runs happen (default cuda; without a "
                        "card pass --device cpu)")
    args = ap.parse_args(argv)
    return {"list": cmd_list, "show": cmd_show, "diff": cmd_diff,
            "timeline": cmd_timeline, "smoke": cmd_smoke}[args.cmd](args)
