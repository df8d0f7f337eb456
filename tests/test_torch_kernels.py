"""Hopper CD kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and ``nvcc`` and skips without them. On
a machine with a card (the reference package need not be installed):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py

Tolerance: max|kernel - plain| <= 1e-5 * max(1, max|plain|) — the two
compute the same recurrence in fp32 and differ only in the order of the
per-step dot product's sum (and FMA contraction).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import cd_glm

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(out, ref):
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    assert math.isfinite(err) and err <= TOL * max(1.0, scale), (err, scale)


def _inputs(k, d, n_k, seed, dev, pad=0):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(k, d, n_k)) / np.sqrt(d)).astype(np.float32)
    a[:, :, n_k - pad:] = 0.0                      # padded columns
    if n_k > 1:
        a[0, :, 1] = 0.0                           # a zero-norm column
    mask = np.ones((k, n_k), np.float32)
    mask[:, n_k - pad:] = 0.0
    t = lambda v: torch.as_tensor(np.ascontiguousarray(v), device=dev)
    return dict(a=t(a), a_cols=t(a.transpose(0, 2, 1)),
                x=t(0.1 * rng.normal(size=(k, n_k)).astype(np.float32)),
                grads=t(rng.normal(size=(k, d)).astype(np.float32)),
                lin=t(rng.normal(size=(k, n_k)).astype(np.float32)),
                mask=t(mask))


PROX = [(0.0, 1e-2, math.inf), (0.05, 0.0, 10.0), (0.0, 1.0, math.inf),
        (5e-3, 5e-3, 1e3)]


@pytest.mark.parametrize("k,d,n_k,pad", [(3, 64, 20, 0), (4, 300, 37, 3),
                                         (2, 30_000, 5, 1),
                                         (2, 8, 12_000, 0)])
@pytest.mark.parametrize("prox", PROX)
@pytest.mark.parametrize("budget", [False, True])
def test_residual_kernel_matches_plain(cuda, k, d, n_k, pad, prox, budget):
    inp = _inputs(k, d, n_k, seed=d + n_k, dev=cuda, pad=pad)
    steps = 2 * n_k if n_k < 1000 else n_k // 4
    budgets = (torch.tensor([(i * steps) // max(k - 1, 1) for i in range(k)],
                            dtype=torch.int32, device=cuda)
               if budget else None)
    l1, l2, box = prox
    kw = dict(num_steps=steps, sigma_over_tau=float(k), l1=l1, l2=l2,
              box=box, budgets=budgets)
    args = (inp["a_cols"], inp["x"], inp["grads"], inp["lin"], inp["mask"])
    before = cd_glm.LAUNCHES["cd_residual"]
    out = cd_glm.cd_solve_blocks(*args, **kw)
    torch.cuda.synchronize()
    assert cd_glm.LAUNCHES["cd_residual"] == before + 1
    _close(out, cd_glm.cd_residual_plain(*args, **kw))


@pytest.mark.parametrize("k,n_k", [(3, 20), (4, 125), (2, 236), (2, 300)])
@pytest.mark.parametrize("prox", PROX)
@pytest.mark.parametrize("budget", [False, True])
def test_gram_kernel_matches_plain(cuda, k, n_k, prox, budget):
    inp = _inputs(k, 2 * n_k, n_k, seed=n_k, dev=cuda, pad=2)
    gram = torch.bmm(inp["a"].transpose(1, 2), inp["a"]).contiguous()
    atg = torch.bmm(inp["grads"].unsqueeze(1), inp["a"]).squeeze(1)
    steps = 3 * n_k
    budgets = (torch.tensor([0] + [steps // 2] * (k - 1), dtype=torch.int32,
                            device=cuda) if budget else None)
    l1, l2, box = prox
    kw = dict(num_steps=steps, sigma_over_tau=float(k), l1=l1, l2=l2,
              box=box, budgets=budgets)
    args = (gram, inp["x"], atg, inp["lin"], inp["mask"])
    before = cd_glm.LAUNCHES["cd_gram"]
    out = cd_glm.cd_solve_blocks_gram(*args, **kw)
    torch.cuda.synchronize()
    assert cd_glm.LAUNCHES["cd_gram"] == before + 1
    _close(out, cd_glm.cd_gram_plain(*args, **kw))


def test_wrappers_reject_bad_inputs(cuda):
    inp = _inputs(2, 16, 8, seed=0, dev=cuda)
    kw = dict(num_steps=8, sigma_over_tau=2.0, l1=0.0, l2=1.0, box=math.inf)
    good = (inp["a_cols"], inp["x"], inp["grads"], inp["lin"], inp["mask"])
    with pytest.raises(ValueError, match="contiguous"):
        cd_glm.cd_solve_blocks(inp["a"].transpose(1, 2), *good[1:], **kw)
    with pytest.raises(TypeError, match="dtype"):
        cd_glm.cd_solve_blocks(good[0].double(), *good[1:], **kw)
    with pytest.raises(ValueError, match="is on"):
        cd_glm.cd_solve_blocks(*good[:4], good[4].cpu(), **kw)
    with pytest.raises(TypeError, match="dtype"):
        cd_glm.cd_solve_blocks(*good, **dict(
            kw, budgets=torch.zeros(2, dtype=torch.int64, device=cuda)))
