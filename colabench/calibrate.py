"""The readings that a cell's limits are set from, in one process.

    python3 colabench/calibrate.py --workload <cell> --seeds <n> --control <m> [--first-seed <s>]

For each of ``n`` seeds: the cell's data, one solve through the timed
path (``harness.Session.answer``: the ``run_cola`` call the window makes)
and the plain reference in fp32; the compared numbers
(``check.numbers``) of the program against it. For the first ``m`` seeds
also the control: the reference computed in TF32 (``precision="tf32"``,
the nearest precision below the configuration's fp32 with TF32 off), put
in the program's place and judged the same way. Prints one JSON line a
seed and side, then the lower reading of each number (the largest over
the program's seeds) and the upper one (the smallest over the control's),
as the last line. A limit lies between the two (PERF.md, "How correct is
decided").
"""
import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2_147_483_659)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(CHECKOUT / "src"), str(CHECKOUT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    import torch
    from colabench import check, harness, registry
    c = registry.cell(args.workload)
    if args.device == "cuda":
        harness.check_card(c)
    sound, control = [], []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        t0 = time.perf_counter()
        s = harness.Session(c, seed, args.device)
        got = s.answer()
        s.release()
        t1 = time.perf_counter()
        want = s.reference("fp32")
        t2 = time.perf_counter()
        nums = check.numbers(got, want, s.max_rounds)
        sound.append(nums)
        print(json.dumps({"side": "program", "seed": seed, **nums,
                          "stop_round": got["stop_round"],
                          "ref_stop_round": want.stop_round,
                          "solve_s": t1 - t0, "reference_s": t2 - t1}),
              flush=True)
        if i < args.control:
            low = s.reference("tf32")
            nums = check.numbers({"x_parts": low.x_parts,
                                  "v_stack": low.v_stack,
                                  "history": dict(low.history,
                                                  stop_round=low.stop_round)},
                                 want, s.max_rounds)
            control.append(nums)
            print(json.dumps({"side": "control", "seed": seed, **nums,
                              "stop_round": low.stop_round,
                              "control_s": time.perf_counter() - t2}),
                  flush=True)
        del s, want
        if args.device == "cuda":
            torch.cuda.empty_cache()
    out = {"workload": args.workload}
    for k in check.NUMBERS:
        out[k] = {"lower": max(n[k] for n in sound),
                  "upper": min((n[k] for n in control), default=None)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
