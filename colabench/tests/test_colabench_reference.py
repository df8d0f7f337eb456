"""The plain reference against the port on the CPU at a small size, and
the control: the reference in TF32 (the precision below the cells' fp32
with TF32 off) fails the comparison that decides ``correct``."""
from __future__ import annotations

import math

import pytest
import torch

from colabench import check, harness, registry
from colabench.reference import cola as ref

CELLS = [w["name"] for w in registry.bench_spec()["workloads"]]


def control(low) -> dict:
    """The reference's result in the program's place."""
    return {"x_parts": low.x_parts, "v_stack": low.v_stack,
            "history": dict(low.history, stop_round=low.stop_round)}


def _data(n, f, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((n, f), generator=gen) / math.sqrt(n)
    y = x @ torch.randn((f,), generator=gen) + 0.1 * torch.randn(
        (n,), generator=gen)
    return x, y


def test_linear_block_is_the_coordinate_loop():
    gen = torch.Generator().manual_seed(1)
    rows = torch.randn((3, 50, 20), generator=gen)
    x, lin = torch.randn((3, 50), generator=gen), torch.randn(
        (3, 50), generator=gen)
    grads = torch.randn((3, 20), generator=gen)
    mask = torch.ones((3, 50))
    mask[2, 40:] = 0
    rows[1, 7] = 0.0                      # a zero column makes no update
    loop = ref.cd_loop(rows, x, grads, lin, mask, 50, 7.0, 0.0, 1.0,
                       math.inf)
    block = ref.cd_linear_block(ref.Products("fp32"), rows, x, grads, lin,
                                mask, 7.0, 1.0, chunk=16)
    assert torch.allclose(block, loop, rtol=1e-5, atol=1e-6)


def test_gram_loop_is_the_coordinate_loop():
    gen = torch.Generator().manual_seed(2)
    rows = torch.randn((2, 12, 30), generator=gen)
    x, grads = torch.randn((2, 12), generator=gen), torch.randn(
        (2, 30), generator=gen)
    lin, mask = torch.zeros((2, 12)), torch.ones((2, 12))
    loop = ref.cd_loop(rows, x, grads, lin, mask, 30, 3.0, 0.1, 0.0, 0.5)
    gram = ref.cd_gram((rows @ rows.transpose(1, 2)).numpy(), x.numpy(),
                       (rows @ grads[..., None])[..., 0].numpy(),
                       lin.numpy(), mask.numpy(), 30, 3.0, 0.1, 0.0, 0.5)
    assert torch.allclose(torch.from_numpy(gram), loop, rtol=1e-5,
                          atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_reference_matches_the_port(tiny_root, name):
    """Each cell's timed path at a tiny size, against the reference: the
    comparison passes under the cell's own limits, and the stop round is
    the same."""
    c = registry.cell(name, tiny_root)
    s = harness.Session(c, seed=2 ** 31 + 3, device="cpu")
    got = s.answer()
    want = s.reference("fp32")
    assert got["stop_round"] is not None
    assert got["stop_round"] == want.stop_round
    ok, nums = check.judge([got], want, c["cell"]["limits"], s.max_rounds)
    assert ok, nums


@pytest.mark.parametrize("name", CELLS)
def test_a_tf32_run_is_not_correct(tiny_root, name):
    """The control: the reference computed in TF32 in the program's
    place fails at least one compared number."""
    c = registry.cell(name, tiny_root)
    s = harness.Session(c, seed=2 ** 31 + 5, device="cpu")
    want = s.reference("fp32")
    low = s.reference("tf32")
    ok, nums = check.judge([control(low)], want, c["cell"]["limits"],
                           s.max_rounds)
    assert not ok, nums


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_on_the_card(tiny_root, cuda, name):
    """The same two readings on the card: the CD kernels pass, TF32 fails."""
    c = registry.cell(name, tiny_root)
    s = harness.Session(c, seed=2 ** 31 + 7, device=cuda)
    got = s.answer()
    s.release()
    want = s.reference("fp32")
    low = s.reference("tf32")
    limits = c["cell"]["limits"]
    assert check.judge([got], want, limits, s.max_rounds)[0]
    assert not check.judge([control(low)], want, limits, s.max_rounds)[0]


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -12, -3.0])
    out = ref.tf32_round(t)
    assert out.tolist() == [1.0, 1.0, 1.0 + 4 * 2 ** -11, 1.0, -3.0]
