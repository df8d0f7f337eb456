"""Host-side phase tracing: spans, executor cache events, Chrome export.

A ``Tracer`` records named wall-clock spans (per-block dispatch, bench
repeats) plus the executor's cache events (``executor.cache_listener``),
and exports the whole timeline as Chrome-trace JSON (``chrome://tracing``
/ Perfetto). Every span also opens ``torch.profiler.record_function`` so
the same names show up inside a device profile when one is being taken
(``torch_profile``).

Spans time the host. PyTorch runs eagerly and returns before the card
finishes, so a block span measures how long the block takes to ENQUEUE,
plus the block's read of the stop flag when a stop is armed (that read
waits for the card). The device's time is the profiler's or CUDA events'.

A module-level default tracer is always installed — ``span()`` costs two
``perf_counter`` calls, a ``record_function`` and a deque append, so
instrumented code paths (executor block dispatches) call it
unconditionally. Scoped collection swaps in a fresh tracer::

    with obs.trace.use(obs.trace.Tracer()) as tr, tr.attach():
        run()
    tr.export("trace.json")
"""
from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Any

import torch

from repro_torch.core import executor

#: default tracer keeps a bounded window so long sessions don't grow it
_DEFAULT_MAXLEN = 4096


class Tracer:
    """Collects spans + executor cache events relative to its creation."""

    def __init__(self, name: str = "repro_torch", maxlen: int | None = None):
        self.name = name
        self.spans: collections.deque = collections.deque(maxlen=maxlen)
        self.cache_events: collections.deque = collections.deque(
            maxlen=maxlen)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str, **meta: Any):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.spans.append({"name": name, "t0": t0 - self._t0,
                               "dur": time.perf_counter() - t0,
                               "meta": meta})

    def _on_cache(self, key, kind: str) -> None:
        self.cache_events.append({"t": time.perf_counter() - self._t0,
                                  "kind": kind, "key": repr(key)})

    @contextlib.contextmanager
    def attach(self):
        """Record the executor's cache events while active — a removable
        ``executor.cache_listener``, so nested tracers each count their own
        events exactly once."""
        with executor.cache_listener(self._on_cache):
            yield self

    def cache_stats(self) -> dict:
        out = {"hits": 0, "misses": 0, "bypass": 0}
        for ev in self.cache_events:
            out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def summary(self) -> dict:
        """Span timings aggregated by name (count + total seconds) — the
        compact form a RunReport stores."""
        agg: dict = {}
        for s in self.spans:
            ent = agg.setdefault(s["name"], {"count": 0, "total_s": 0.0})
            ent["count"] += 1
            ent["total_s"] += s["dur"]
        for ent in agg.values():
            ent["total_s"] = round(ent["total_s"], 6)
        return {"spans": agg, "cache": self.cache_stats()}

    def chrome_trace(self) -> dict:
        """The timeline as Chrome trace-event JSON."""
        evs = []
        for s in self.spans:
            evs.append({"name": s["name"], "ph": "X", "pid": 1, "tid": 1,
                        "ts": s["t0"] * 1e6, "dur": s["dur"] * 1e6,
                        "args": {str(k): str(v)
                                 for k, v in s["meta"].items()}})
        for ev in self.cache_events:
            evs.append({"name": f"driver-cache {ev['kind']}", "ph": "i",
                        "pid": 1, "tid": 2, "ts": ev["t"] * 1e6, "s": "t",
                        "args": {"key": ev["key"]}})
        return {"traceEvents": evs, "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path


_STACK: list = [Tracer(maxlen=_DEFAULT_MAXLEN)]


def current() -> Tracer:
    """The active tracer (innermost ``use()`` scope, else the default)."""
    return _STACK[-1]


@contextlib.contextmanager
def use(tracer: Tracer):
    """Install ``tracer`` as the active tracer within the scope."""
    _STACK.append(tracer)
    try:
        yield tracer
    finally:
        _STACK.remove(tracer)


@contextlib.contextmanager
def run_tracer(on: bool = True):
    """A fresh tracer, with its executor cache listener, active for one
    telemetry run (yields None when ``on`` is False), so the run's report
    holds exactly its own block dispatches."""
    if not on:
        yield None
        return
    with use(Tracer()) as tracer, tracer.attach():
        yield tracer


def span(name: str, **meta: Any):
    """Record a span on the ACTIVE tracer: ``with obs.trace.span("x"): ...``"""
    return current().span(name, **meta)


@contextlib.contextmanager
def torch_profile(logdir: str, device="cuda"):
    """Bridge to ``torch.profiler``: profiles the scope's CPU activity and,
    when ``device`` is a card, its CUDA activity, and writes the Chrome
    trace ``<logdir>/trace.json`` on exit; span annotations recorded inside
    the scope appear as named host regions in it. Yields the profiler
    (``key_averages()`` sums device time by kernel)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    with prof:
        yield prof
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
