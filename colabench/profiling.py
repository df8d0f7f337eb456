"""One traced stretch of work, reduced to what the metrics and the
breakdown read: device busy time, kernel time by name, and the longest
idle gaps named by what the host was doing.

The work runs once under ``torch.profiler`` (CPU and CUDA activities)
inside a ``record_function`` range (``WINDOW``) that bounds the traced
window on the profiler's own clock, which the host's and the device's
events share. A ``record_function`` range is also drawn on the device's
timeline (the port's ``block-dispatch`` spans are); those are host spans,
not device work, and are left out of it.
"""
from __future__ import annotations

import torch

WINDOW = "colabench.window"
TOP = 10
NAME_CHARS = 120


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_name(gap, host: list) -> str:
    """The host op that overlaps the gap most (the shortest such, so the
    innermost); where no op does, the range that does (a stretch of
    Python inside it); else ``host (no op)``."""
    g0, g1 = gap
    best, best_key = "host (no op)", (0, 0.0, 0.0)
    for name, s, e, is_range in host:
        ov = min(e, g1) - max(s, g0)
        if ov > 0:
            key = (0 if is_range else 1, ov, -(e - s))
            if key > best_key:
                best, best_key = name, key
    return best


def reduce(events, window_name: str = WINDOW) -> dict:
    """``events``: the profiler's ``FunctionEvent``s. Returns the traced
    window's length and busy time (s), the kernels by name
    (``{name: {"device_s", "calls"}}``), the ``TOP`` device ops by time
    and the ``TOP`` longest idle gaps, each ``[name, seconds]``."""
    from torch.autograd import DeviceType
    win = [e for e in events
           if e.name == window_name and e.device_type == DeviceType.CPU]
    if not win:
        raise ValueError(f"no {window_name!r} range in the trace")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    ranges = {e.name for e in events if getattr(e, "is_user_annotation",
                                                False)}
    dev, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == window_name or t <= w0 or s >= w1:
            continue
        if e.device_type == DeviceType.CUDA:
            if e.name in ranges or getattr(e, "is_user_annotation", False):
                continue
            dev.append((e.name, max(s, w0), min(t, w1)))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, s, t, e.name in ranges))
    kernels: dict = {}
    for name, s, t in dev:
        k = kernels.setdefault(name, {"device_s": 0.0, "calls": 0})
        k["device_s"] += (t - s) * 1e-6
        k["calls"] += 1
    busy = _merge([(s, t) for _, s, t in dev])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1]["device_s"])
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(t - s for s, t in busy) * 1e-6,
        "kernels": kernels,
        "device_ops": [[name[:NAME_CHARS], v["device_s"]]
                       for name, v in top_ops[:TOP]],
        "idle_gaps": [[_host_name(g, host)[:NAME_CHARS], (g[1] - g[0]) * 1e-6]
                      for g in gaps[:TOP]],
    }


def traced(fn):
    """Run ``fn()`` once under the profiler; returns ``(fn's result,
    reduce(...) of its window)``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            out = fn()
            torch.cuda.synchronize()
    return out, reduce(prof.events())
