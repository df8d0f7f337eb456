"""Device time of one robust gossip step (the trim / median gate,
``mixing.robust_mix_dense``) on the card, at two widths: run_a's
(K = 16 on torus_2d(4, 4), d = 400,000) and the baselines' (d = 2,000).

The payloads are finite (N(0, 1) from a seed, two nodes sending a 10x
sign-flipped copy), so the step is the one a defended run pays on every
round. Device ms: CUDA events around ``--reps`` steps queued behind a
sleep kernel, so the host's launch cost is left out; ``ms`` is the same
without the sleep. Prints one JSON line labelled ``--tree``.

It imports ``repro_torch`` from ``PYTHONPATH``, so one call can compare
two trees on the same card (run them as A, B, B, A):

  PYTHONPATH=src python examples/torch_gate_cost.py --tree change
  PYTHONPATH=<other checkout>/src python examples/torch_gate_cost.py \\
      --tree parent
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import mixing, topology as topo


def _events_ms(fn, reps: int, sleep_ms: float = 0.0) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if sleep_ms:
        # cycles at 2 GHz: the H100's SM clock is at most 1.98 GHz
        torch.cuda._sleep(int(sleep_ms * 2e6))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def step_ms(fn, reps: int) -> tuple:
    """(ms, device ms) per call of ``fn``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    return (_events_ms(fn, reps),
            _events_ms(fn, reps, sleep_ms=2.0 + 4.0 * reps * host_ms))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default="this")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    graph = topo.torus_2d(4, 4)
    k = graph.num_nodes
    w = torch.as_tensor(topo.metropolis_weights(graph).astype(np.float32),
                        device="cuda")
    rng = np.random.default_rng(args.seed)
    out = {"tree": args.tree, "device": torch.cuda.get_device_name(0)}
    for width, d in (("full", 400_000), ("small", 2_000)):
        v = rng.standard_normal((k, d)).astype(np.float32)
        v[[0, 10]] *= -10.0
        v = torch.as_tensor(v, device="cuda")
        for mode in ("trim", "median"):
            ms, dev = step_ms(lambda: mixing.robust_mix_dense(w, v, mode),
                              args.reps)
            out[f"{width}_{mode}_ms"] = ms
            out[f"{width}_{mode}_device_ms"] = dev
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
