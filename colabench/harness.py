"""One run of one cell: set-up, the measured window, an optional traced
solve, the check against the plain reference, and the result line.

The user this measures solves a COLA problem to a target, back to back
(a closed loop of one). Each solve is one call of
``repro_torch.run_cola`` from a fresh state, on the block executor, with
the cell's recorder, cadence and target: the call builds the partition,
the environment (the Gram blocks or the residual layout) and the
schedule, as a user's call does, and returns at the stop round or at
``max_rounds``. The window runs solves for ``seconds`` and finishes the
one under way, so it holds whole solves.
"""
from __future__ import annotations

import math
import sys
import time
from pathlib import Path

import torch

from colabench import check, datagen, peaks, profiling, registry
from colabench.reference import cola as ref

# top-level module names that may not be loaded once the window has
# closed: the JAX package (whose name the port's begins with) and JAX
BLOCKED = ("jax", "jaxlib", "flax", "repro")


class NoCard(RuntimeError):
    """The card or cards the cell asks for are not there."""


class BlockedImport(RuntimeError):
    """The process loaded JAX or the JAX package."""


def blocked_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BLOCKED)


def problem_shapes(config: dict, traffic: dict) -> dict:
    """The sizes the rooflines and metrics read: A is (d, n) over K
    blocks of n_k; the lasso splits features, the ridge dual samples."""
    k = config["nodes"]
    lasso = config["problem"] == "lasso"
    d = config["n_samples"] if lasso else config["n_features"]
    n = config["n_features"] if lasso else config["n_samples"]
    n_k = -(-n // k)
    adj = ref.GRAPHS[config["graph"]](k)
    return {"k": k, "d": d, "n": n, "n_k": n_k,
            "steps": max(1, int(round(config["kappa"] * n_k))),
            "nnz_w": int(adj.sum()) + k, "data_len": d if lasso else n,
            "record_every": traffic["record_every"],
            "certificate": "certificate" in traffic["recorder"]}


def executed_rounds(history: dict, max_rounds: int, block: int) -> int:
    """Rounds the block executor ran: all, or up to the end of the block
    that holds the stop round."""
    stop = history["stop_round"]
    if stop is None:
        return max_rounds
    return min(max_rounds, -(-(stop + 1) // block) * block)


class Session:
    """A cell's program on its data: ``answer()`` runs one solve as the
    window runs it (one ``run_cola`` call to the cell's target) and takes
    its result to the host; ``reference(precision)`` solves the same data
    with the plain reference."""

    def __init__(self, c: dict, seed: int, device: str):
        t0 = time.perf_counter()
        import repro_torch as rt
        from repro_torch.core import topology
        from repro_torch.kernels import build, cd_glm
        self.c, self.device = c, device
        config, traffic, own = c["config"], c["traffic"], c["cell"]
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t1 = time.perf_counter()
        if device == "cuda":
            build.build_all(["cd_glm"])
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self.x, self.y = datagen.make(config, seed, device)
        if device == "cuda":
            torch.cuda.synchronize()
        # where set-up goes: the port's import, the kernels' library (and
        # the card's context), the data
        self.parts = {"import_s": t1 - t0, "kernels_s": t2 - t1,
                      "data_s": time.perf_counter() - t2}
        kw = {"box": config["box"]} if config["problem"] == "lasso" else {}
        self.problem = rt.PROBLEMS[config["problem"]](
            self.x, self.y, config["lam"], device=device, **kw)
        self.graph = topology.TOPOLOGIES[config["graph"]](config["nodes"])
        self.cfg = rt.ColaConfig(kappa=config["kappa"], wire=traffic["wire"])
        self.block = traffic["block_size"]
        self.max_rounds = own["max_rounds"]
        self._rt, self._launches = rt, cd_glm

    def solve(self, rounds: int):
        traffic = self.c["traffic"]
        return self._rt.run_cola(
            self.problem, self.graph, self.cfg, rounds,
            record_every=traffic["record_every"],
            recorder=traffic["recorder"], eps=self.c["cell"]["eps"],
            executor="block", block_size=self.block, seed=0,
            device=self.device)

    def answer(self) -> dict:
        """One solve, taken as its caller takes it: the state and the
        history on the host."""
        t0 = time.perf_counter()
        self._launches.reset_launches()
        res = self.solve(self.max_rounds)
        out = {"x_parts": res.state.x_parts.cpu(),
               "v_stack": res.state.v_stack.cpu(), "history": res.history,
               "stop_round": res.history["stop_round"],
               "executed_rounds": executed_rounds(
                   res.history, self.max_rounds, self.block),
               "launches": dict(self._launches.LAUNCHES)}
        out["wall_s"] = time.perf_counter() - t0
        return out

    def release(self) -> None:
        """Drop the program's hold on the card (the data stays)."""
        self.problem = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "fp32"):
        config, traffic = self.c["config"], self.c["traffic"]
        return ref.solve(config["problem"], self.x, self.y,
                         lam=config["lam"], box=config.get("box", math.inf),
                         nodes=config["nodes"], graph=config["graph"],
                         kappa=config["kappa"], recorder=traffic["recorder"],
                         record_every=traffic["record_every"],
                         eps=self.c["cell"]["eps"],
                         max_rounds=self.max_rounds, precision=precision)


def check_card(c: dict) -> None:
    chips = c["entry"]["chips"]
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        raise NoCard(f"cell {c['name']!r} needs {chips} CUDA device(s); "
                     f"this machine has {have}")


def run(name: str, seed: int, seconds: float, trace: bool, *,
        root: Path = registry.ROOT, device: str = "cuda",
        started: float | None = None, log=sys.stderr) -> dict:
    """Run cell ``name``; returns the result object (last line of the
    benchmark's output). ``started``: the process's start on
    ``time.perf_counter``'s clock (set-up is measured from it)."""
    t_start = time.perf_counter() if started is None else started
    c = registry.cell(name, root)
    on_card = device == "cuda"
    if on_card:
        check_card(c)
    elif trace:
        raise ValueError("a traced run reads the card's profiler trace")
    t_run = time.perf_counter()
    s = Session(c, seed, device)
    # warm-up: one block of the cell's own shapes
    t_warm = time.perf_counter()
    s.solve(s.block)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    parts = {"start_s": t_run - t_start, **s.parts,
             "warm_s": time.perf_counter() - t_warm}

    solves, errors = [], []
    w0 = time.perf_counter()
    while True:
        try:
            solves.append(s.answer())
        except (RuntimeError, ValueError) as e:
            errors.append(f"{type(e).__name__}: {e}")
            break
        if time.perf_counter() - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    summary, traced = None, []
    if trace and not errors:
        out, summary = profiling.traced(s.answer)
        traced.append(out)
    failed = len(errors) + sum(a["stop_round"] is None
                               for a in solves + traced)

    # the check: the reference solves the same data once the window has
    # closed and the program's state is gone
    s.release()
    t_ref = time.perf_counter()
    want = s.reference()
    parts["reference_s"] = time.perf_counter() - t_ref
    correct, checks = check.judge(solves + traced, want, c["cell"]["limits"],
                                  s.max_rounds)
    correct = correct and not errors

    record = {"setup_s": setup_s, "window_s": window_s,
              "solves": [{k: a[k] for k in ("stop_round", "executed_rounds",
                                             "launches", "wall_s")}
                         for a in solves],
              "peak_mem_bytes": peak, "trace": summary,
              "shapes": problem_shapes(c["config"], c["traffic"])}
    metrics = {}
    for m in (c["per_layer"] if trace else c["end_to_end"]):
        value = (registry.load_module("metrics", m["name"], root).read(record)
                 if solves else None)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device,
           "kind": torch.cuda.get_device_name(0) if on_card else device,
           "count": c["entry"]["chips"], "memory_peak_bytes": peak}
    if on_card:
        # not read by the driver: the limit the card ran under
        dev["power_limit"] = peaks.card()["power_limit"]
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
    result = {"correct": correct,
              "attempted": len(solves) + len(traced) + len(errors),
              "failed": failed, "metrics": metrics, "device": dev}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    # not read by the driver: where set-up went, and the check's time
    result["seconds"] = parts
    found = blocked_modules()
    if found:
        raise BlockedImport("loaded by the end of the run: " + ", ".join(found))
    for e in errors:
        print(f"solve failed: {e}", file=log)
    for k, v in checks.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=log)
    log.flush()
    result["checks"] = checks
    return result
