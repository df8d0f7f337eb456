"""Op-count analysis of an eager program: flops, bytes and collectives.

The port's counterpart of the reference's ``src/repro/launch/hlo_analysis
.py``. The reference re-derives the roofline inputs from compiled HLO text
because XLA's own cost analysis counts a ``while`` body once, whatever its
trip count. An eager PyTorch program has no HLO: it runs every loop trip
as its own ops, so an op trace (``analysis.passes.trace_ops``) counts each
trip by construction, and no trip count needs parsing.

``analyze(fn, *args, axis=None)`` runs ``fn`` once under the trace and
returns the reference's keys:

* ``flops`` — exact for the matmul family (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``mv``, ``addmv``, ``dot``: 2 x output elements x
  contraction, as ``_dot_flops`` counts a ``dot``); 1 x output elements for
  every other op that computes (views and allocations count nothing);
* ``bytes`` — every executed op's operands plus its results. A view or a
  slice is counted as the bytes it reads, not its base's: the operand is
  the view, and the view op itself moves nothing (the twin of the
  reference's ``_sliced_param_reads``);
* ``collectives`` / ``collective_counts`` — per kind, from the
  ``NodeAxis`` given as ``axis`` (what it counted during ``fn``), in the
  reference's accounting (``axis_report``); zeros without one.

Kernels launched through ctypes are invisible to the trace: ``opaque``
lists their launches by name, and their work is not guessed (counting it
belongs to the benchmark twins). ``ops`` is the number of aten ops run.
"""
from __future__ import annotations

#: collective kinds of a report: the reference's, plus ``broadcast``
#: (``NodeAxis.broadcast``; no reference program issues one)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")


def _report(calls: dict, sent: dict, size: int) -> dict:
    coll = {k: 0.0 for k in COLLECTIVES}
    counts = {k: 0.0 for k in COLLECTIVES}
    for kind, n in calls.items():
        key = "collective-permute" if kind == "permute" else kind
        counts[key] += n
    for kind, b in sent.items():
        if kind == "permute":
            coll["collective-permute"] += b
        elif kind == "all-reduce":
            coll["all-reduce"] += 2 * b   # reduce + broadcast
        elif kind == "all-gather":
            coll["all-gather"] += size * b  # the gathered result
        else:
            coll[kind] += b
    coll["total"] = sum(coll[k] for k in COLLECTIVES)
    counts["total"] = sum(counts[k] for k in COLLECTIVES)
    return {"collectives": coll, "collective_counts": counts}


def axis_report(axis, since: tuple | None = None) -> dict:
    """A ``NodeAxis``'s counts as the reference's report: ``permute`` is
    ``collective-permute``; all-reduce bytes count twice (reduce +
    broadcast, the reference's ``contracts.py:37``); all-gather bytes are
    the gathered result a rank holds (its sent bytes x the group's size);
    ``broadcast`` counts what the root sends. ``since``: ``(calls, sent)``
    dicts taken earlier, to report only what came after."""
    calls, sent = dict(axis.counts), dict(axis.sent_bytes)
    if since is not None:
        calls = {k: n - since[0].get(k, 0) for k, n in calls.items()}
        sent = {k: b - since[1].get(k, 0) for k, b in sent.items()}
    return _report(calls, sent, axis.size)


def analyze(fn, *args, axis=None, **kwargs) -> dict:
    """Flops, bytes and collectives of one run of ``fn(*args, **kwargs)``
    (see the module); ``result`` holds what ``fn`` returned."""
    from repro_torch.analysis import passes
    since = None if axis is None else (dict(axis.counts),
                                       dict(axis.sent_bytes))
    trace = passes.trace_ops(fn, *args, sync_debug=False, **kwargs)
    report = (axis_report(axis, since) if axis is not None
              else _report({}, {}, 1))
    return {"flops": float(sum(op.flops for op in trace.ops)),
            "bytes": float(sum(op.traffic for op in trace.ops)), **report,
            "opaque": trace.launch_counts(), "ops": len(trace.ops),
            "result": trace.result}
