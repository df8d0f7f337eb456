"""The readers of the port's spans (``program_spans.py`` and the seven
``program_span`` metrics): each over a tracer whose aggregate is set by
hand, each with no spans to read, and a tiny solve on the CPU under the
profiler, where the spans carry no device time."""
from __future__ import annotations

import pytest
import torch

from colabench import program_spans, registry
from repro_torch import convert, topo
from repro_torch.core import cola
from repro_torch.data import synthetic
from repro_torch.obs import trace as obs_trace

# metric -> (span, field, the span whose count divides)
READS = {"solve_setup_ms": ("cola.setup", "device_s", "cola.setup"),
         "mix_ms": ("cola.mix", "device_s", "round"),
         "local_solve_ms": ("cola.local_solve", "device_s", "round"),
         "update_ms": ("cola.update", "device_s", "round"),
         "record_ms": ("round-record", "device_s", "round-record"),
         "certificate_ms": ("record.certificate", "device_s",
                            "record.certificate"),
         "block_gap_ms": ("block-gap", "total_s", "block-gap")}
# name -> [count, host s, device s, timed pairs], as a card run leaves it
AGG = {"cola.setup": [1, 0.0125, 0.1875, 1],
       "round": [768, 3.25, 3.375, 768],
       "cola.mix": [768, 0.03125, 0.0384, 768],
       "cola.local_solve": [768, 1.5, 1.536, 768],
       "cola.update": [768, 0.5, 1.152, 768],
       "round-record": [48, 0.125, 0.3, 48],
       "record.certificate": [48, 0.0625, 0.2, 48],
       "block-gap": [11, 0.011, 0.0, 0]}


def read(name):
    return registry.load_module("metrics", name).read({})


def test_every_program_span_metric_has_its_reader():
    spec = registry.bench_spec()
    named = {m["name"] for m in spec["per_layer"]
             if m["source"] == "program_span"}
    assert named == set(READS)


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_over_a_set_aggregate(name):
    span, field, per = READS[name]
    tracer = obs_trace.Tracer()
    tracer._agg.update({k: list(v) for k, v in AGG.items()})
    with obs_trace.use(tracer):
        got = read(name)
    value = AGG[span][2 if field == "device_s" else 1]
    assert got == pytest.approx(1e3 * value / AGG[per][0], rel=1e-6)
    assert got > 0


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_without_spans(name):
    with obs_trace.use(obs_trace.Tracer()):
        assert read(name) is None


def test_ms_needs_the_field_and_a_count():
    tracer = obs_trace.Tracer()
    tracer._agg.update({"block-gap": [0, 0.0, 0.0, 0],
                        "cola.mix": [3, 0.003, 0.0, 0]})
    with obs_trace.use(tracer):
        assert program_spans.ms("block-gap", "total_s") is None
        # no device time: the spans ran off the card
        assert program_spans.ms("cola.mix", "device_s") is None
        assert program_spans.ms("cola.mix", "total_s") == pytest.approx(1.0)
        assert program_spans.ms("cola.mix", "total_s", per="round") is None


# certified first at round 8 of the 120 x 48 lasso on torus2d(16), a
# certificate every second round, blocks of 4: the third block
CERT_EPS = 1900.0
BLOCK = 4


def test_tiny_solve_under_the_profiler(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    monkeypatch.setattr(obs_trace, "_STACK", [obs_trace.Tracer()])
    x, y, _ = synthetic.regression(120, 48, seed=1, sparsity_solution=0.2)
    problem = convert.problem_from_numpy("lasso", x, y, 1e-3, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        res = cola.run_cola(problem, topo.build("torus2d", 16),
                            cola.ColaConfig(), 10 * BLOCK,
                            recorder="gap+certificate", record_every=2,
                            eps=CERT_EPS, block_size=BLOCK, device="cpu")
    assert res.history["stop_round"] // BLOCK == 2
    assert not torch.cuda.is_initialized()
    for name in ("solve_setup_ms", "mix_ms", "local_solve_ms", "update_ms",
                 "record_ms", "certificate_ms"):
        assert read(name) is None, name
    gap = read("block_gap_ms")
    assert isinstance(gap, float) and gap > 0
    assert program_spans.totals()["block-gap"]["count"] == 2
