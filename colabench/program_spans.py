"""The port's own span totals (``repro_torch.obs.trace``), as the readers
of the ``program_span`` metrics take them.

The harness reads the per-layer metrics in its own process after the
traced solve, the one solve it runs under ``torch.profiler``. The port's
spans collect only where a scoped tracer is installed or a profiler
session is on, and then on the default tracer, so that tracer's aggregate
holds the traced solve's spans and no other: by name, ``count``, host
seconds ``total_s`` and, timed on the card by CUDA events, ``device_s``.

A reader gets ``None`` where the program opens no such span (one older
than the spans), where the span counted nothing, or where the field it
reads is missing (no ``device_s`` off the card); it never raises.
"""
from __future__ import annotations

import sys


def totals() -> dict:
    """``{span name: {"count", "total_s"[, "device_s"]}}`` of the port's
    active tracer; empty where there is none to read."""
    try:
        from repro_torch.obs import trace
        return dict(trace.current().summary().get("spans", {}))
    except Exception as e:  # a reader reports nothing, never fails a run
        print(f"colabench: no program spans ({type(e).__name__}: {e})",
              file=sys.stderr)
        return {}


def ms(name: str, field: str, per: str | None = None) -> float | None:
    """Milliseconds of span ``name``'s ``field`` (``device_s`` or
    ``total_s``) over the count of span ``per`` (default: ``name``'s
    own)."""
    spans = totals()
    ent, div = spans.get(name), spans.get(per or name)
    if not ent or not div or field not in ent or not div.get("count"):
        return None
    return 1e3 * ent[field] / div["count"]
