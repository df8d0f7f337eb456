"""COLA's benchmark on the card: one run of one cell.

    python3 colabench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of its
standard output (one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last the
compared numbers with their limits under ``checks``); the compared numbers
are also the last lines of its standard error. Exits 3 without a result
where the card is missing, 4 where JAX or the JAX package was loaded.
See colabench/README.md.
"""
import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (CHECKOUT / "src" / "repro_torch").is_dir():
        print(f"colabench: the port (src/repro_torch) is not in {CHECKOUT}",
              file=sys.stderr)
        return 2
    # every cache the program writes stays inside the checkout, at a
    # fixed path (the kernels build into build/repro_torch_kernels)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CHECKOUT / "build" / sub)
    here = Path(__file__).resolve().parent
    sys.path[:] = [str(CHECKOUT / "src"), str(CHECKOUT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    from colabench import harness
    try:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), started=_STARTED)
    except harness.NoCard as e:
        print(f"colabench: {e}", file=sys.stderr)
        return 3
    except harness.BlockedImport as e:
        print(f"colabench: {e}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
