"""CLI: hold every registered COLA driver configuration to its contracts.

``python -m repro_torch.analysis --all``       AST lints + every driver
``python -m repro_torch.analysis --selftest``  every seeded violation caught
``python -m repro_torch.analysis --driver dist-plan``  one driver by name

The drivers run on ``--device`` (default cuda: without a card the CLI
refuses unless ``--device cpu`` is given). ``--ranks M`` (M > 1) spawns
M ranks once — a gloo group on the CPU, NCCL with one card per rank on
CUDA — and runs every driver and fixture that needs ranks over them; the
reference's 8 virtual devices become 4 gloo ranks, and ``dist-block``'s
3-rank program runs on a subgroup. Without them those drivers SKIP.

Exit status 0 = every contract holds (and, under ``--selftest``, every
seeded violation was caught); 1 otherwise.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import shutil
import sys
import tempfile
import time

# the spawned ranks' time limit, beside each collective's own 120 s
RANKS_TIMEOUT_S = 600


def _src_root() -> pathlib.Path:
    return pathlib.Path(__file__).resolve().parent.parent.parent


def run_ast(paths=None) -> int:
    from repro_torch.analysis import astlint
    paths = paths or [_src_root()]
    findings = astlint.lint_paths(paths)
    for f in findings:
        print(f"FAIL ast: {f}")
    print(f"ast-lint: {len(findings)} finding(s) over {len(paths)} root(s) "
          f"[{len(astlint.RULES)} rule(s)]")
    return len(findings)


def spawn_ranks(world: int, device: str, drivers_: list,
                selftests: list) -> dict:
    """Run the named drivers and fixtures on ``world`` spawned ranks;
    ``{"driver:<name>" | "selftest:<name>": merged result}``."""
    import torch.multiprocessing as mp
    from repro_torch.analysis import drivers
    out_dir = tempfile.mkdtemp(prefix="analysis_ranks_")
    try:
        ctx = mp.spawn(drivers.rank_worker,
                       args=(world, out_dir, device, drivers_, selftests),
                       nprocs=world, join=False)
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        crash = None
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    crash = f"the ranks ran past {RANKS_TIMEOUT_S} s"
                    break
        except Exception as e:  # a rank died: its results say why
            crash = f"a rank failed: {e}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
        rows = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    rows.append(json.load(f))
        out = {}
        for key in [f"driver:{n}" for n in drivers_] + \
                [f"selftest:{n}" for n in selftests]:
            got = [r[key] for r in rows if key in r]
            out[key] = (drivers.merge_ranks(got) if got and not crash
                        else {"status": "crash", "findings": [],
                              "detail": crash or "no rank reported"})
        return out
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)


def print_driver(name: str, result: dict) -> int:
    """One driver's lines; 1 if it failed."""
    if result["status"] == "skip":
        print(f"SKIP {name}: {result['detail']}")
        return 0
    if result["status"] != "findings":
        print(f"FAIL {name}: driver crashed\n{result['detail']}")
        return 1
    if result["findings"]:
        print(f"FAIL {name}: {len(result['findings'])} finding(s)")
        for f in result["findings"]:
            print(f"  {f}")
        return 1
    print(f"PASS {name}")
    return 0


def print_selftest(name: str, caught, detail: str) -> int:
    """One fixture's line; 1 if its violation was missed."""
    if caught is None:
        print(f"SKIP selftest {name}: {detail}")
        return 0
    if caught:
        print(f"CAUGHT {name}: {detail.splitlines()[0]}")
        return 0
    print(f"MISSED {name}: {detail}")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="contract analysis of the port's COLA programs (see "
                    "repro_torch.analysis.__doc__)")
    ap.add_argument("--all", action="store_true",
                    help="AST lints + every registered driver (default)")
    ap.add_argument("--ast", action="store_true", help="AST lints only")
    ap.add_argument("--driver", action="append", metavar="NAME",
                    help="run one registered driver (repeatable)")
    ap.add_argument("--selftest", action="store_true",
                    help="run the seeded-violation fixtures; fail unless "
                         "every one is caught")
    ap.add_argument("--list", action="store_true",
                    help="list registered drivers, passes and rules")
    ap.add_argument("--device", default="cuda",
                    help="where the drivers run (default cuda; without a "
                         "card pass --device cpu)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="spawn this many ranks for the drivers that "
                         "exchange over ranks (gloo on the CPU)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import astlint, drivers, passes, selftest
    if args.list:
        print("drivers: " + ", ".join(sorted(drivers.DRIVER_REGISTRY)))
        print("passes:  " + ", ".join(sorted(passes.PASS_REGISTRY)))
        print("rules:   " + ", ".join(sorted(astlint.RULES)))
        print("selftests: " + ", ".join(sorted(selftest.SELFTESTS)))
        return 0
    from repro_torch.device import resolve
    device = str(resolve(args.device))

    names = []
    if args.driver:
        names = list(args.driver)
    if args.all or not (args.selftest or args.ast or args.driver):
        names = sorted(drivers.DRIVER_REGISTRY)
    tests = list(selftest.SELFTESTS) if args.selftest else []
    unknown = [n for n in names if n not in drivers.DRIVER_REGISTRY]
    names = [n for n in names if n not in unknown]
    on_ranks = lambda fn: getattr(fn, "ranks", 0) > 0
    ranked = {}
    if args.ranks > 1:
        ranked = spawn_ranks(
            args.ranks, device,
            [n for n in names if on_ranks(drivers.DRIVER_REGISTRY[n])],
            [n for n in tests if on_ranks(selftest.SELFTESTS[n])])

    failures = 0
    with drivers.settings(device=device):
        for name in tests:
            key = f"selftest:{name}"
            row = (selftest.caught_row(name, ranked[key]) if key in ranked
                   else selftest.run_selftests([name])[0])
            failures += print_selftest(*row)
        if args.ast or args.all or not (args.selftest or args.driver):
            failures += run_ast()
        for name in unknown:
            print(f"FAIL {name}: unknown driver (have: "
                  f"{', '.join(sorted(drivers.DRIVER_REGISTRY))})")
            failures += 1
        for name in names:
            key = f"driver:{name}"
            failures += print_driver(
                name, ranked[key] if key in ranked
                else drivers.run_one(drivers.DRIVER_REGISTRY[name]))
    print(f"repro_torch.analysis: {'FAIL' if failures else 'OK'} "
          f"({failures} failing check(s))")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
