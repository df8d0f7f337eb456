"""The byte and FLOP counts at small shapes against hand-worked values,
each metric reader against a recorded, synthetic run record, and the
trace reduction against synthetic profiler events."""
from __future__ import annotations

import types

import pytest

from colabench import peaks, profiling, registry


def test_cd_gram_count():
    # G 2x3x3, four (K, n_k) inputs, K budgets, dx out; 5 steps of
    # 2 n_k + 12
    assert registry.load_module("rooflines", "cd_gram").cost(2, 3, 5) == \
        (4 * (18 + 24 + 2) + 24, 2 * 5 * 18)


def test_cd_residual_count():
    # A's 2x3 columns of 4, three (K, n_k) inputs, grads, budgets, dx out;
    # 5 steps of 4 d, and the 2 n_k d of the norms
    assert registry.load_module("rooflines", "cd_residual").cost(
        2, 3, 4, 5) == (4 * (24 + 18 + 8 + 2) + 24, 2 * (5 * 16 + 24))


def test_round_count():
    # K=2, d=4, n=6, n_k=3: A once (24), v in and out (16), x in and out
    # (12), y (4), W (4): 240 B; 4 d n + 2 nnz d + K d + 12 K steps =
    # 96 + 32 + 8 + 72 FLOPs. A record (every 2nd round) reads A, v and x
    # (38 floats) and does 4 d n + 2 d n + K d = 152 FLOPs.
    cost = registry.load_module("rooflines", "round").cost
    assert cost(2, 4, 6, 3, 3, 4, 4, 2, True) == (240 + 152 / 2,
                                                   208 + 152 / 2)
    assert cost(2, 4, 6, 3, 3, 4, 4, 1, False) == (240 + 152, 208 + 96)


def test_least_seconds():
    t, by = peaks.least_seconds(3.35e12, 1.0)
    assert (t, by) == (1.0, "bytes")
    t, by = peaks.least_seconds(1.0, 67e12)
    assert (t, by) == (1.0, "operations")


SHAPES = {"k": 16, "d": 400_000, "n": 2_000, "n_k": 125, "steps": 125,
          "nnz_w": 48, "data_len": 400_000, "record_every": 16,
          "certificate": True}


def record(**kw):
    solve = {"stop_round": 752, "executed_rounds": 768,
             "launches": {"cd_gram": 768, "cd_residual": 0}, "wall_s": 5.0}
    rec = {"setup_s": 7.5, "window_s": 20.0, "solves": [dict(solve)] * 4,
           "peak_mem_bytes": 7_200_000_000, "shapes": dict(SHAPES),
           "trace": {"window_s": 4.0, "busy_s": 3.9, "kernels": {
               "void cd_gram_kernel<true>(float const*, int)":
                   {"device_s": 768 * 1.3e-5, "calls": 768},
               "gemv2T_kernel": {"device_s": 1.5, "calls": 1536}}}}
    rec.update(kw)
    return rec


def read(name, rec):
    return registry.load_module("metrics", name).read(rec)


def test_readers():
    rec = record()
    assert read("solve_s", rec) == 5.0
    assert read("setup_s", rec) == 7.5
    assert read("rounds_per_solve", rec) == 768
    assert read("round_ms", rec) == pytest.approx(20_000 / 3072)
    nbytes, flops = registry.load_module("rooflines", "round").cost(
        16, 400_000, 2_000, 125, 125, 48, 400_000, 16, True)
    least = max(nbytes / 3.35e12, flops / 67e12)
    assert read("round_mfu", rec) == pytest.approx(
        100 * least / (20.0 / 3072))
    nbytes, flops = registry.load_module("rooflines", "cd_gram").cost(
        16, 125, 125)
    assert read("cd_gram_roofline", rec) == pytest.approx(
        100 * max(nbytes / 3.35e12, flops / 67e12) / 1.3e-5)
    assert read("device_idle", rec) == pytest.approx(2.5)
    assert read("peak_mem_gb", rec) == pytest.approx(7.2)


def test_readers_return_nothing_without_their_source():
    rec = record()
    # the residual kernel did not run in a lasso cell
    assert read("cd_residual_roofline", rec) is None
    # no trace
    rec = record(trace=None)
    for name in ("cd_gram_roofline", "cd_residual_roofline", "device_idle"):
        assert read(name, rec) is None
    # launches that disagree with the executed rounds
    bad = dict(record()["solves"][0], launches={"cd_gram": 700,
                                                "cd_residual": 0})
    assert read("rounds_per_solve", record(solves=[bad])) is None


def _ev(name, device, start, end, annotation=False):
    from torch.autograd import DeviceType
    return types.SimpleNamespace(
        name=name, device_type=getattr(DeviceType, device),
        time_range=types.SimpleNamespace(start=start, end=end),
        is_user_annotation=annotation)


def test_trace_reduction():
    events = [_ev(profiling.WINDOW, "CPU", 0, 100),
              _ev("aten::mm", "CPU", 10, 30),
              _ev("aten::item", "CPU", 40, 50),
              _ev("cudaStreamSynchronize", "CPU", 60, 95),
              _ev("k1", "CUDA", 15, 25), _ev("k2", "CUDA", 55, 90),
              _ev("k1", "CUDA", 92, 94),
              # a host range, also drawn on the device's timeline
              _ev("block-dispatch", "CPU", 5, 99, annotation=True),
              _ev("block-dispatch", "CUDA", 5, 99)]
    s = profiling.reduce(events)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(47e-6)
    assert s["kernels"]["k1"]["calls"] == 2
    assert [n for n, _ in s["device_ops"]] == ["k2", "k1"]
    assert s["device_ops"][1][1] == pytest.approx(12e-6)
    gaps = s["idle_gaps"]
    assert [n for n, _ in gaps] == ["aten::item", "aten::mm",
                                    "cudaStreamSynchronize",
                                    "cudaStreamSynchronize"]
    assert "block-dispatch" not in s["kernels"]
    assert [g for _, g in gaps] == pytest.approx([30e-6, 15e-6, 6e-6, 2e-6])
