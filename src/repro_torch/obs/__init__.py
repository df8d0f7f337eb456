"""``repro_torch.obs`` — run telemetry for the port's drivers.

Three layers, all opt-in (a telemetry-off run runs the same operations on
the same state, bitwise):

* **On-device counters** (``obs.counters``): a ``Counters`` tuple carried
  in the round state (``ColaConfig.telemetry=True``) accumulating
  per-round wire bytes and exchange counts (from the compiled plan's
  contract budget), the step-0 payload's saturation and the EF residual
  norm (``repro_torch.core.quant``), and robust-gate edge rejections per
  sender. Every signal comes from what the round computed: the gate's
  mask from the mix that ran (``mixing.robust_neighborhood_mix(sig=)``),
  the payload from the round's own encode. Totals land in every driver's
  ``history["telemetry"]``.
* **Spans** (``obs.trace``): named phases of a solve, collected only
  inside a scoped tracer (``use``, ``run_tracer``) or, on the default
  tracer, while a ``torch.profiler`` session is on; otherwise ``span()``
  is one shared no-op (no ``record_function``, no clock read). Collected,
  a span opens ``torch.profiler.record_function``, reads the host clock
  and, on a card, records a CUDA event pair, and closes into a per-name
  aggregate (``count``, ``total_s``, ``device_s``) that ``summary()``
  returns. ``run_cola`` opens ``cola.setup`` (its per-call set-up); the
  executor ``round`` (one executed round), ``round-record`` (a record and
  the stop update), ``block-first-dispatch`` / ``block-dispatch`` (a
  block's enqueue), ``block-stop-read`` (the stop flag's read) and
  ``block-gap`` (the flag read's return to the next block's first round);
  the round body ``cola.mix``, ``cola.local_solve`` and ``cola.update``;
  the certificate recorder ``record.certificate``. Also: executor cache
  events via ``executor.cache_listener``, Chrome-trace JSON export, and
  ``torch_profile`` for a device trace.
* **Run registry** (``obs.report``): telemetry runs append a ``RunReport``
  JSONL line under ``.repro_runs/`` (env ``REPRO_RUNS_DIR`` overrides,
  ``off`` disables); ``python -m repro_torch.obs list|show|diff|timeline``
  queries it.
"""
from repro_torch.obs.counters import (Counters, init_counters, make_update,
                                      round_increments, summarize)
from repro_torch.obs.report import (RunReport, append_report, diff_reports,
                                    load_reports, runs_file)
from repro_torch.obs.trace import Tracer, current, span, use

__all__ = [
    "Counters", "RunReport", "Tracer", "append_report", "current",
    "diff_reports", "init_counters", "load_reports", "make_update",
    "round_increments", "runs_file", "span", "summarize", "use",
]
