"""Host-side phase tracing: named spans, executor cache events, Chrome export.

Collection is opt-in. ``span()`` records only

* inside a scoped tracer (``use(Tracer())``, ``run_tracer()``), or
* while a ``torch.profiler`` session is on: the module's default tracer
  then collects, so a profile's spans are exactly those of the work it
  traced.

Otherwise ``span()`` returns one shared no-op context: no
``record_function``, no clock read, no allocation; what it costs is the
gate's two lookups (a fraction of a microsecond a span).

A collecting span opens ``torch.profiler.record_function`` (the name is
then a range of a device profile), reads the host clock at its entry and
exit and, once CUDA is initialised in the process, records a
``torch.cuda.Event`` pair on the current stream. It closes into a running
aggregate by name: ``count``, host seconds ``total_s`` and, where events
were recorded, device seconds ``device_s``, the card's own clock between
the two points of the stream. PyTorch returns before the card finishes,
so a span around enqueued work times its enqueue on the host and its work
on the device. The event pairs are resolved with one synchronize when
``summary()`` is read (past a bound, the oldest as spans close). On, a
span costs the ``record_function`` (microseconds even with no profiler
running), two clock reads and, on a card, two event records.

The spans the port opens (``repro_torch.core``):

=======================  ====================================================
``cola.setup``           ``run_cola``: ``build_env`` (A's blocks, the Gram
                         blocks or the residual layout), the recorder (σ_k),
                         the schedule, the round body
``round``                the executor: one executed round (body, record,
                         stop update, select)
``cola.mix``             the round body: Step 4, the gossip mix (every wire)
``cola.local_solve``     grad f (and the mixed gradient), the CD solve, the
                         active and work masks
``cola.update``          Steps 6-8: x, A dx, v (and the pipelined encode)
``round-record``         the executor: the recorder's row and the stop update
``record.certificate``   the certificate recorder's row
``block-first-dispatch``,
``block-dispatch``       the executor: a block's enqueue only
``block-stop-read``      the executor: the host's read of the stop flag
``block-gap``            the executor: from the flag read's return to the
                         next block's first round (the card is drained)
=======================  ====================================================

A scoped collection::

    with obs.trace.use(obs.trace.Tracer()) as tr, tr.attach():
        run()
    tr.summary()["spans"]        # {name: {"count", "total_s"[, "device_s"]}}
    tr.export("trace.json")      # the raw spans, bounded by ``maxlen``
"""
from __future__ import annotations

import collections
import contextlib
import json
import time
from typing import Any

import torch
import torch.autograd.profiler as _profiler

from repro_torch.core import executor

#: the raw spans the default tracer keeps for the Chrome export (the
#: aggregate counts every span)
_DEFAULT_MAXLEN = 4096
#: event pairs held before the oldest are folded in as spans close
_PENDING_MAX = 4096


class _Off:
    """The shared no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """One collecting span of ``tracer`` (see the module)."""

    __slots__ = ("_tracer", "_name", "_meta", "_rf", "_events", "_t0")

    def __init__(self, tracer: "Tracer", name: str, meta: dict):
        self._tracer, self._name, self._meta = tracer, name, meta

    def __enter__(self):
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        self._events = None
        if torch.cuda.is_initialized():
            stream = torch.cuda.current_stream()
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            self._events = (start, stream)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        pair = None
        if self._events is not None:
            start, stream = self._events
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            pair = (start, end)
        self._rf.__exit__(*exc)
        self._tracer._close(self._name, self._t0, t1, self._meta, pair)
        return False


class Tracer:
    """Collects spans + executor cache events relative to its creation.
    ``maxlen`` bounds the raw spans kept for the Chrome export; the
    aggregate that ``summary()`` returns counts every span."""

    def __init__(self, name: str = "repro_torch", maxlen: int | None = None):
        self.name = name
        self.spans: collections.deque = collections.deque(maxlen=maxlen)
        self.cache_events: collections.deque = collections.deque(
            maxlen=maxlen)
        self._t0 = time.perf_counter()
        # name -> [count, host seconds, device seconds, device pairs]
        self._agg: dict = {}
        # (name, start event, end event), oldest first
        self._pending: collections.deque = collections.deque()

    def span(self, name: str, **meta: Any):
        """A span on this tracer, collected whatever the gate says."""
        return _Span(self, name, meta)

    def _close(self, name: str, t0: float, t1: float, meta: dict,
               pair) -> None:
        self.spans.append({"name": name, "t0": t0 - self._t0,
                           "dur": t1 - t0, "meta": meta})
        ent = self._agg.get(name)
        if ent is None:
            ent = self._agg[name] = [0, 0.0, 0.0, 0]
        ent[0] += 1
        ent[1] += t1 - t0
        if pair is not None:
            self._pending.append((name, *pair))
            # past the bound, each close folds the oldest pair if the card
            # has passed it: the list stays near the bound and no close
            # holds the host up (a held-up host lets the card run dry)
            if len(self._pending) > _PENDING_MAX and \
                    self._pending[0][2].query():
                self._fold(*self._pending.popleft())

    def _fold(self, name: str, start, end) -> None:
        ent = self._agg[name]
        ent[2] += start.elapsed_time(end) * 1e-3
        ent[3] += 1

    def _resolve(self) -> None:
        """Fold every recorded event pair into ``device_s``, after one
        synchronize."""
        if not self._pending:
            return
        torch.cuda.synchronize()
        while self._pending:
            self._fold(*self._pending.popleft())

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
        """Span timings aggregated by name (``count``, host ``total_s`` and,
        for spans timed on a card, ``device_s``), over every span the
        tracer collected — the compact form a RunReport stores."""
        self._resolve()
        agg = {}
        for name, (count, host_s, dev_s, pairs) in self._agg.items():
            agg[name] = {"count": count, "total_s": round(host_s, 6)}
            if pairs:
                agg[name]["device_s"] = round(dev_s, 6)
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
    holds exactly its own spans."""
    if not on:
        yield None
        return
    with use(Tracer()) as tracer, tracer.attach():
        yield tracer


def span(name: str, **meta: Any):
    """A span on the active tracer where collection is on (a scoped tracer,
    or a profiler session for the default one), else the shared no-op:
    ``with obs.trace.span("x"): ...``"""
    if len(_STACK) > 1:
        return _STACK[-1].span(name, **meta)
    if _profiler._is_profiler_enabled:   # set by every profiler session
        return _STACK[0].span(name, **meta)
    return _OFF


@contextlib.contextmanager
def torch_profile(logdir: str, device="cuda"):
    """Bridge to ``torch.profiler``: profiles the scope's CPU activity and,
    when ``device`` is a card, its CUDA activity, and writes the Chrome
    trace ``<logdir>/trace.json`` on exit; spans opened inside the scope
    (on the default tracer when no scoped one is active) appear as named
    host regions in it. Yields the profiler (``key_averages()`` sums
    device time by kernel)."""
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
