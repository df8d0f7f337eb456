"""The op-count analyzer (``repro_torch.launch.op_analysis``) against
hand-computed costs: the twin of ``tests/test_hlo_analysis.py``.

The reference parses compiled HLO text, so its tests pin trip counts of
``scan`` / ``fori_loop`` bodies, ``dot_general`` contraction dims, the
scan's sliced weight reads, and the byte widths of f8 types. An eager
program runs every trip as its own ops: the same costs are held here on
Python loops, ``einsum``, a slice of a stack, float8 tensors and a float8
exchange between two gloo ranks. The reference's two token tests
(``test_parse_shapes_keeps_tokens_as_zero_bytes``,
``test_analyze_token_tuple_collective``) have no counterpart: a PyTorch
program has no token or opaque values to parse.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.launch.op_analysis import analyze

ROOT = Path(__file__).resolve().parents[1]


def _stack_loop(x, w):
    for i in range(w.shape[0]):
        x = torch.tanh(x @ w[i])
    return x.sum()


@pytest.mark.parametrize("length", [2, 8, 32])
def test_loop_matmul_flops_scale_with_trip_count(length):
    r = analyze(_stack_loop, torch.zeros(128, 128),
                torch.zeros(length, 128, 128))
    expect = length * 2 * 128 ** 3
    assert 0.95 * expect <= r["flops"] <= 1.1 * expect


def test_nested_loop_multiplicity():
    def g(x, w):
        for i in range(w.shape[0]):
            for _ in range(4):
                x = torch.tanh(x @ w[i])
        return x.sum()

    r = analyze(g, torch.zeros(128, 128), torch.zeros(8, 128, 128))
    expect = 8 * 4 * 2 * 128 ** 3
    assert 0.95 * expect <= r["flops"] <= 1.1 * expect


def test_einsum_contraction_dims():
    r = analyze(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                torch.zeros(4, 32, 48), torch.zeros(4, 48, 16))
    expect = 2 * 4 * 32 * 16 * 48
    assert 0.95 * expect <= r["flops"] <= 1.3 * expect


def test_traffic_counts_the_slice_not_the_stack():
    """Each trip reads one layer of the stack, not the whole stack."""
    big_l, d = 16, 256

    def f(x, w):
        for i in range(w.shape[0]):
            x = x @ w[i]
        return x.sum()

    r = analyze(f, torch.zeros(d, d), torch.zeros(big_l, d, d))
    per_trip = 3 * d * d * 4          # read w_l and x, write the product
    stack_bytes = big_l * d * d * 4
    assert r["bytes"] < big_l * stack_bytes * 0.7
    assert r["bytes"] >= big_l * per_trip * 0.5


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_float8_tensors_count_one_byte_an_element(dtype):
    x = torch.zeros(8, 16)
    r = analyze(lambda t: t.to(dtype), x)
    # read 8 x 16 fp32, write 8 x 16 float8
    assert r["bytes"] == 8 * 16 * 4 + 8 * 16


_RANK = textwrap.dedent("""
    import datetime, json, sys
    import torch, torch.distributed as dist
    from repro_torch.dist.axis import NodeAxis
    from repro_torch.launch.op_analysis import analyze
    rank, store = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    axis = NodeAxis()
    x = torch.full((64,), 0.5).to(torch.float8_e5m2)
    r = analyze(lambda t: axis.permute(t, [(0, 1), (1, 0)]), x, axis=axis)
    got = r["result"].to(torch.float32)
    if rank == 0:
        print(json.dumps({"bytes": r["collectives"]["collective-permute"],
                          "count": r["collective_counts"]
                          ["collective-permute"],
                          "total": r["collectives"]["total"],
                          "value": float(got.max())}))
    dist.destroy_process_group()
""")


def test_float8_permute_counts_one_byte_an_element(tmp_path):
    """A float8 exchange between two gloo ranks: 64 elements, 64 bytes
    (``NodeAxis`` sends it as its uint8 bits), one exchange."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    store = str(tmp_path / "store")
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(r), store],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    got = json.loads(outs[0][0].strip().splitlines()[-1])
    assert got == {"bytes": 64, "count": 1, "total": 64, "value": 0.5}
