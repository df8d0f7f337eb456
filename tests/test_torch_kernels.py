"""Hopper kernels (CD solvers, flash attention) against their plain
PyTorch versions, on the card.

Every test here but the 3xTF32 emulation (which runs on the CPU) needs a
CUDA device and ``nvcc`` and skips without them. On a machine with a card
(the reference package need not be installed):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels.py

CD tolerance: max|kernel - plain| <= 1e-5 * max(1, max|plain|) — the two
compute the same recurrence in fp32 and differ only in the order of the
per-step dot product's sum, FMA contraction, and (Gram kernel) the prox
multiplying by reciprocals that a prologue computed where the plain version
divides.

Flash attention: fp32 at 2e-5 (atol and rtol, the bar of
``tests/test_kernels.py`` for the Pallas kernel); bf16 outputs within 2 bf16
ulps of |plain| plus 1e-6 — both compute in fp32 and round once to bf16,
so they differ by the rounding of an fp32 result that is itself a few fp32
ulps apart.
"""
import _torch_cpu  # noqa: F401  (one PyTorch thread per test worker)
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import cd_glm
from repro_torch.kernels import flash_attention as fa

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


# layouts (``cd_glm.residual_layout``): r/grad in registers with the row
# ring (64, 300, 2,001 with 4-byte row copies), in shared memory with the
# ring (5,000) and without it (12,000), in global scratch without the ring
# (30,000); n_k = 12,000 spans twelve scalar chunks, n_k = 1 is one slot
@pytest.mark.parametrize("k,d,n_k,pad", [(3, 64, 20, 0), (4, 300, 37, 3),
                                         (2, 30_000, 5, 1),
                                         (2, 8, 12_000, 0),
                                         (2, 5_000, 40, 2),
                                         (2, 12_000, 30, 0),
                                         (3, 2_001, 50, 1),
                                         (2, 64, 1, 0)])
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


def test_residual_layout_covers_every_placement(cuda):
    """r/grad in registers, in shared memory, in scratch; rows through the
    ring or from global memory (what the card tests above exercise), as the
    launcher in csrc/cd_glm.cu decides them."""
    lay = cd_glm.residual_layout
    assert lay(2_000, 128) == {"threads": 128, "rpt": 16, "r_smem": False,
                               "scratch": False, "stages": 8}
    assert lay(2_000, 64)["rpt"] == 32 and lay(2_000, 256)["rpt"] == 8
    assert lay(5_000, 128) == {"threads": 128, "rpt": 0, "r_smem": True,
                               "scratch": False, "stages": 7}
    assert lay(12_000, 128)["r_smem"] and lay(12_000, 128)["stages"] == 0
    assert lay(30_000, 128) == {"threads": 128, "rpt": 0, "r_smem": False,
                                "scratch": True, "stages": 0}
    with pytest.raises(ValueError, match="threads"):
        lay(2_000, 100)


@pytest.mark.parametrize("d,n_k,steps,threads", [
    (2_001, 2_500, 6_250, 128),   # three chunks, the last short; wraps twice
    (2_000, 2_048, 5_000, 64),    # two chunks: write-back then read-back
    (300, 1_030, 2_100, 256),     # a 6-coordinate last chunk (< ring depth)
    (30_000, 1_500, 3_200, 128),  # chunks without the ring
])
@pytest.mark.parametrize("budget", [False, True])
def test_residual_kernel_chunks_and_threads(cuda, d, n_k, steps, threads,
                                            budget):
    """The per-coordinate scalars move through shared-memory chunks of
    1,024 coordinates (kChunk in csrc/cd_glm.cu): walks that leave, revisit
    and wrap around chunks, with budgets that stop inside a chunk, at 64,
    128 and 256 threads (the counts chip_smoke.py times)."""
    k = 3
    inp = _inputs(k, d, n_k, seed=d + steps, dev=cuda, pad=3)
    budgets = (torch.tensor([steps, 1_500, 1_025][:k], dtype=torch.int32,
                            device=cuda) if budget else None)
    kw = dict(num_steps=steps, sigma_over_tau=float(k), l1=5e-3, l2=5e-3,
              box=1e3, budgets=budgets)
    args = (inp["a_cols"], inp["x"], inp["grads"], inp["lin"], inp["mask"])
    out = cd_glm._residual_launch(*args, threads, **kw)
    torch.cuda.synchronize()
    _close(out, cd_glm.cd_residual_plain(*args, **kw))


@pytest.mark.parametrize("k,n_k", [(3, 20), (4, 125), (2, 236), (2, 300),
                                 (1000, 2)])
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


def _nonsymmetric_gram(a, seed):
    """A^T A plus a non-symmetric perturbation with a zero diagonal: a
    kernel that read row i of G instead of column i would disagree."""
    gram = torch.bmm(a.transpose(1, 2), a)
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(rng.normal(size=tuple(gram.shape))
                            .astype(np.float32), device=a.device)
    noise -= torch.diag_embed(torch.diagonal(noise, dim1=1, dim2=2))
    scale = 0.2 * float(gram.abs().mean())
    return (gram + scale * noise).contiguous()


# G streamed through the ring (n_k > 236) up to the rule's 1,448, and
# resident below; budgets stop some nodes mid-pass
@pytest.mark.parametrize("k,n_k", [(2, 125), (2, 236), (2, 300), (3, 500),
                                   (2, 1_000), (2, 1_448)])
@pytest.mark.parametrize("budget", [False, True])
def test_gram_kernel_reads_columns(cuda, k, n_k, budget):
    inp = _inputs(k, 2 * n_k, n_k, seed=n_k + 1, dev=cuda, pad=3)
    gram = _nonsymmetric_gram(inp["a"], seed=n_k)
    assert not torch.equal(gram, gram.transpose(1, 2))
    atg = torch.bmm(inp["grads"].unsqueeze(1), inp["a"]).squeeze(1)
    steps = 2 * n_k + 7
    budgets = (torch.tensor([n_k + 5] + [steps] * (k - 1), dtype=torch.int32,
                            device=cuda) if budget else None)
    kw = dict(num_steps=steps, sigma_over_tau=float(k), l1=5e-3, l2=5e-3,
              box=1e3, budgets=budgets)
    args = (gram, inp["x"], atg, inp["lin"], inp["mask"])
    before = cd_glm.LAUNCHES["cd_gram"]
    out = cd_glm.cd_solve_blocks_gram(*args, **kw)
    torch.cuda.synchronize()
    assert cd_glm.LAUNCHES["cd_gram"] == before + 1
    ref = cd_glm.cd_gram_plain(*args, **kw)
    _close(out, ref)
    # the env's prebuilt layout gives the same result
    out2 = cd_glm.cd_solve_blocks_gram(
        *args, gram_cols=cd_glm.gram_columns(gram), **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)


def test_gram_kernel_rejects_what_it_does_not_take(cuda):
    inp = _inputs(1, 8, cd_glm.GRAM_MAX_NK + 1, seed=0, dev=cuda)
    n_k = cd_glm.GRAM_MAX_NK + 1
    gram = torch.zeros((1, n_k, n_k), device=cuda)
    kw = dict(num_steps=4, sigma_over_tau=1.0, l1=0.0, l2=1.0, box=1.0)
    with pytest.raises(ValueError, match="n_k <="):
        cd_glm.cd_solve_blocks_gram(gram, inp["x"], inp["x"], inp["lin"],
                                    inp["mask"], **kw)
    inp = _inputs(1, 8, 6, seed=0, dev=cuda)
    gram = torch.eye(6, device=cuda)[None]
    with pytest.raises(ValueError, match="gram_cols has shape"):
        cd_glm.cd_solve_blocks_gram(gram, inp["x"], inp["x"], inp["lin"],
                                    inp["mask"], gram_cols=gram, **kw)


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


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _attn_inputs(b, sq, skv, h, kvh, hd, dtype, dev, seed, ring=False):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    q = t(rng.normal(size=(b, sq, h, hd)).astype(np.float32)).to(dtype)
    k = t(rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)).to(dtype)
    v = t(rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)).to(dtype)
    q_pos = np.tile(np.arange(skv - sq, skv), (b, 1)).astype(np.int32)
    kv_pos = np.tile(np.arange(skv), (b, 1)).astype(np.int32)
    if ring:  # rotated slots, the last quarter empty
        kv_pos = np.tile((np.arange(skv) + 7) % skv, (b, 1)).astype(np.int32)
        kv_pos[:, -(skv // 4):] = -1
        q_pos = np.tile(np.arange(skv, skv + sq), (b, 1)).astype(np.int32)
    return q, k, v, t(q_pos), t(kv_pos)


def _attn_close(out, ref):
    assert out.dtype == ref.dtype and out.shape == ref.shape
    o, r = out.float(), ref.float()
    if ref.dtype == torch.float32:
        err = (o - r).abs()
        assert bool((err <= 2e-5 + 2e-5 * r.abs()).all()), float(err.max())
    else:
        _, e = torch.frexp(r)            # |r| = m 2^e, m in [0.5, 1)
        ulp = torch.ldexp(torch.ones_like(r), e - 8)   # bf16: 8 mantissa bits
        bound = 2 * ulp + 1e-6
        assert bool(((o - r).abs() <= bound).all()), \
            float(((o - r).abs() - bound).max())


ATTN_CASES = [
    # (b, sq, skv, h, kvh, hd, mode, window, ring)
    (2, 32, 32, 4, 2, 16, "causal", 0, False),
    (2, 32, 32, 4, 2, 16, "sliding", 8, False),
    (2, 32, 32, 4, 4, 16, "chunked_local", 8, False),
    (2, 8, 24, 4, 2, 16, "cross", 0, False),
    (1, 1, 40, 8, 2, 32, "causal", 0, False),
    (2, 17, 23, 8, 2, 32, "causal", 0, False),
    (3, 5, 37, 6, 3, 8, "chunked_local", 4, False),
    (2, 1, 300, 32, 8, 128, "causal", 0, False),    # decode, G = 4
    (2, 100, 260, 32, 8, 128, "causal", 0, False),  # chunked prefill
    (2, 3, 200, 8, 8, 120, "sliding", 64, True),    # ring with -1 slots
    (1, 70, 150, 4, 1, 24, "sliding", 33, True),
    (2, 40, 90, 4, 2, 64, "cross", 0, True),
    (1, 33, 80, 6, 3, 112, "causal", 0, False),
    (1, 20, 70, 4, 2, 160, "chunked_local", 16, False),
    (1, 20, 70, 4, 2, 192, "causal", 0, False),
    (1, 65, 129, 4, 1, 256, "causal", 0, False),
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, case, dtype):
    b, sq, skv, h, kvh, hd, mode, window, ring = case
    q, k, v, qp, kp = _attn_inputs(b, sq, skv, h, kvh, hd, dtype, cuda,
                                   seed=sum(case[:6]), ring=ring)
    route = fa.select_route(dtype, sq, h // kvh)
    before = dict(fa.LAUNCHES)
    out = fa.flash_attention(q, k, v, qp, kp, mode=mode, window=window)
    torch.cuda.synchronize()
    want = {"split": ("flash_split", "flash_combine")}.get(
        route, (f"flash_{route}",))
    assert {n: fa.LAUNCHES[n] - before[n] for n in fa.LAUNCHES} == \
        {n: int(n in want) for n in fa.LAUNCHES}
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp, mode=mode,
                                              window=window))


def test_flash_kernel_fully_masked_rows_give_zero(cuda):
    q, k, v, qp, kp = _attn_inputs(2, 4, 20, 4, 2, 16, torch.float32, cuda,
                                   seed=0)
    kp[0] = -1                       # batch row 0: every slot empty
    qp[1, 0] = -5                    # a query before every key
    out = fa.flash_attention(q, k, v, qp, kp, mode="causal")
    torch.cuda.synchronize()
    assert float(out[0].abs().max()) == 0.0
    assert float(out[1, 0].abs().max()) == 0.0
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp,
                                              mode="causal"))


def test_flash_kernel_reads_strided_inputs(cuda):
    """q, k, v as views with the last dim contiguous (the wrapper passes
    strides; nothing is copied)."""
    q, k, v, qp, kp = _attn_inputs(2, 9, 30, 8, 2, 32, torch.float32, cuda,
                                   seed=1)
    qkv = torch.cat([q.reshape(2, 9, 2, 4 * 32)] * 3, dim=-1)
    qs = qkv[..., :4 * 32].reshape(2, 9, 8, 32)
    big_k = torch.stack([k, -k], dim=3)[:, :, :, 0]   # (B, Skv, KV, hd) view
    assert not big_k.is_contiguous() and big_k.stride(3) == 1
    assert torch.equal(qs, q) and torch.equal(big_k, k)
    out = fa.flash_attention(qs, big_k, v, qp, kp, mode="causal")
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp,
                                              mode="causal"))


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q, k, v, qp, kp = _attn_inputs(1, 4, 8, 4, 2, 16, torch.float32, cuda,
                                   seed=0)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q.half(), k.half(), v.half(), qp, kp,
                           mode="causal")
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.bfloat16(), v, qp, kp, mode="causal")
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(q, k, v, qp.cpu(), kp, mode="causal")
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, v, qp, kp, mode="causal")
    big = torch.zeros((1, 4, 2, 272), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(torch.zeros((1, 4, 4, 272), device=cuda), big,
                           big, qp, torch.zeros((1, 4), dtype=torch.int32,
                                                device=cuda), mode="causal")


# every route over hd in {64, 120, 128, 256}, G in {1, 4, 5} and the four
# modes; Sq = 1 takes the split-KV route, Sq = 37 (ragged against the
# 64-row tiles) the tensor-core route in bf16 and the fp32 route in fp32
ROUTE_SWEEP = [(hd, g, mode, sq)
               for hd in (64, 120, 128, 256) for g in (1, 4, 5)
               for mode in ("causal", "sliding", "chunked_local", "cross")
               for sq in (1, 37)]


@pytest.mark.parametrize("hd,g,mode,sq", ROUTE_SWEEP)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_routes_sweep(cuda, hd, g, mode, sq, dtype):
    b, kvh, skv = 2, 2, 157
    q, k, v, qp, kp = _attn_inputs(b, sq, skv, kvh * g, kvh, hd, dtype,
                                   cuda, seed=hd + g + sq, ring=True)
    kw = dict(mode=mode, window=40)
    out = fa.flash_attention(q, k, v, qp, kp, **kw)
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp, **kw))


def _two_sources(b, sq, cache_len, h, kvh, hd, dtype, dev, seed):
    """A wrapped ring cache (some slots empty) and a fresh chunk after it."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(a, device=dev)
    draw = lambda *shape: t(rng.normal(size=shape).astype(np.float32)
                            ).to(dtype)
    q = draw(b, sq, h, hd)
    k, v = draw(b, cache_len, kvh, hd), draw(b, cache_len, kvh, hd)
    k2, v2 = draw(b, sq, kvh, hd), draw(b, sq, kvh, hd)
    start = cache_len + 5
    kv_pos = np.tile([start - 1 - ((start - 1 - j) % cache_len)
                      for j in range(cache_len)], (b, 1)).astype(np.int32)
    kv_pos[-1, : cache_len // 3] = -1
    q_pos = np.tile(np.arange(start, start + sq), (b, 1)).astype(np.int32)
    return q, k, v, t(q_pos), t(kv_pos), k2, v2, t(q_pos.copy())


@pytest.mark.parametrize("sq,cache_len,mode,window", [
    (1, 1057, "causal", 0),          # decode: 1,057 slots, 33.03 tiles
    (1, 300, "sliding", 100),
    (70, 250, "sliding", 200),       # a chunk against a ring
    (100, 1001, "causal", 0),        # a tile straddles cache and chunk
    (33, 129, "chunked_local", 64),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_two_sources_match_concatenation(cuda, sq, cache_len, mode,
                                               window, dtype):
    q, k, v, qp, kp, k2, v2, kp2 = _two_sources(2, sq, cache_len, 32, 8,
                                                128, dtype, cuda, seed=sq)
    kw = dict(mode=mode, window=window)
    out = fa.flash_attention(q, k, v, qp, kp, k2=k2, v2=v2, kv_pos2=kp2,
                             **kw)
    ref = fa.flash_attention_plain(q, torch.cat([k, k2], 1),
                                   torch.cat([v, v2], 1), qp,
                                   torch.cat([kp, kp2], 1), **kw)
    _attn_close(out, ref)


@pytest.mark.parametrize("splits", [1, 2, 7, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_split_counts(cuda, splits, dtype):
    """1 to 32 splits of 1,057 keys (34 tiles; some splits are empty when
    the tiles run out), then the combine."""
    q, k, v, qp, kp, k2, v2, kp2 = _two_sources(3, 1, 1056, 40, 8, 128,
                                                dtype, cuda, seed=splits)
    kw = dict(mode="causal", k2=k2, v2=v2, kv_pos2=kp2)
    parts = fa.flash_split(q, k, v, qp, kp, splits=splits, **kw)
    out = fa.flash_combine(*parts, sq=1, dtype=dtype)
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp, **kw))


def test_flash_split_and_combine_match_their_plain_versions(cuda):
    """The split kernel's partials against ``flash_split_plain`` (fp32
    reassociation), and the combine kernel against ``flash_combine_plain``
    on the same partials, including a split whose slots are all masked."""
    q, k, v, qp, kp = _attn_inputs(2, 1, 200, 8, 2, 64, torch.float32, cuda,
                                   seed=3)
    kp[:, 64:128] = -1                   # split 1 of 3 (64 keys each) empty
    kw = dict(mode="causal", splits=4)
    m, l, acc = fa.flash_split(q, k, v, qp, kp, **kw)
    pm, pl, pacc = fa.flash_split_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert bool((m[:, :, 1] == -1e30).all()) and bool((l[:, :, 1] == 0).all())
    assert torch.allclose(m, pm, rtol=1e-6, atol=1e-6)
    assert torch.allclose(l, pl, rtol=1e-5, atol=1e-6)
    assert torch.allclose(acc, pacc, rtol=1e-5, atol=1e-5)
    for dtype in (torch.float32, torch.bfloat16):
        out = fa.flash_combine(m, l, acc, sq=1, dtype=dtype)
        ref = fa.flash_combine_plain(m, l, acc, sq=1, dtype=dtype)
        torch.cuda.synchronize()
        if dtype == torch.float32:
            err = (out - ref).abs()
            assert bool((err <= 1e-6 * (1 + ref.abs())).all())
        else:
            _attn_close(out, ref)


@pytest.mark.parametrize("sq", [1, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_unaligned_strides_take_element_copies(cuda, sq, dtype):
    """Views whose rows are not 16-byte aligned: the wrapper falls to
    element copies (never pads or copies the tensors) and stays exact."""
    b, skv, h, kvh, hd = 2, 90, 8, 2, 64
    q, k, v, qp, kp = _attn_inputs(b, sq, skv, h, kvh, hd, dtype, cuda,
                                   seed=sq)
    big_k = torch.zeros((b, skv, kvh, hd + 1), dtype=dtype, device=cuda)
    big_k[..., 1:] = k
    ku = big_k[..., 1:]
    assert ku.stride(3) == 1 and not fa.vec16_ok([q, ku, v], hd)
    out = fa.flash_attention(q, ku, v, qp, kp, mode="causal")
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp,
                                              mode="causal"))


@pytest.mark.parametrize("sq", [1, 40])
def test_flash_bf16_reads_strided_inputs(cuda, sq):
    """bf16 views with 16-byte aligned strides (a fused qkv projection):
    the 16-byte copy path reads them in place."""
    b, skv, h, kvh, hd = 2, 70, 8, 2, 64
    q, k, v, qp, kp = _attn_inputs(b, sq, skv, h, kvh, hd, torch.bfloat16,
                                   cuda, seed=9)
    kv = torch.cat([k, v], dim=-1)                  # (B, Skv, KV, 2 hd)
    ks, vs = kv[..., :hd], kv[..., hd:]
    assert not ks.is_contiguous() and fa.vec16_ok([q, ks, vs], hd)
    out = fa.flash_attention(q, ks, vs, qp, kp, mode="causal")
    _attn_close(out, fa.flash_attention_plain(q, k, v, qp, kp,
                                              mode="causal"))


# the fp32 route (3xTF32 on the tensor cores) in every mode at every padded
# head dim, with the keys as one source and as a cache and a fresh chunk
TF32_SWEEP = [(hd, mode, two) for hd in (64, 120, 128, 256)
              for mode in ("causal", "sliding", "chunked_local", "cross")
              for two in (False, True)]


@pytest.mark.parametrize("hd,mode,two", TF32_SWEEP)
def test_flash_tf32_route_matches_plain(cuda, hd, mode, two):
    sq, cache_len = 40, 150
    q, k, v, qp, kp, k2, v2, kp2 = _two_sources(2, sq, cache_len, 8, 2, hd,
                                                torch.float32, cuda,
                                                seed=hd + sq)
    assert fa.select_route(torch.float32, sq, 4) == "tf32"
    kw = dict(mode=mode, window=64)
    ref = fa.flash_attention_plain(q, torch.cat([k, k2], 1),
                                   torch.cat([v, v2], 1), qp,
                                   torch.cat([kp, kp2], 1), **kw)
    before = fa.LAUNCHES["flash_tf32"]
    if two:
        out = fa.flash_attention(q, k, v, qp, kp, k2=k2, v2=v2, kv_pos2=kp2,
                                 **kw)
    else:
        out = fa.flash_attention(q, torch.cat([k, k2], 1),
                                 torch.cat([v, v2], 1), qp,
                                 torch.cat([kp, kp2], 1), **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_tf32"] == before + 1
    _attn_close(out, ref)


# ---------------------------------------------------------------------------
# why the fp32 route issues three TF32 products (CPU)
# ---------------------------------------------------------------------------

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in torch: keep 10 explicit mantissa bits,
    rounding to nearest with ties away from zero (the sign is a separate
    bit, so adding half of the dropped range to the magnitude does it)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    big = _tf32_rna(x)
    return big, _tf32_rna(x - big)


def _mm_tf32(a, b, parts: int):
    """a @ b on TF32 operands, accumulated in fp32: one product of the
    rounded operands, or the three of the split ones (small*big +
    big*small + big*big)."""
    ab, as_ = _split(a)
    bb, bs = _split(b)
    if parts == 1:
        return ab @ bb
    return as_ @ bb + ab @ bs + ab @ bb


def _attention_tf32(q, k, v, q_pos, kv_pos, mode, window, parts):
    """The fp32 route's math: S = Q K^T and P V as TF32 products, the
    scale, masks and softmax in fp32 (one KV tile: the online softmax's
    rescaling is exact arithmetic in fp32 either way)."""
    from repro_torch.models.attention import _mode_mask
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).permute(0, 2, 3, 1, 4)   # b kh g q d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                      # b kh 1 d s
    s = _mm_tf32(qg, kt, parts) * hd ** -0.5
    mask = _mode_mask(mode, q_pos, kv_pos, window)[:, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    out = _mm_tf32(p, v.permute(0, 2, 1, 3)[:, :, None], parts)
    out = out / p.sum(-1, keepdim=True).clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("mode", ["causal", "sliding", "cross"])
def test_three_tf32_products_meet_the_fp32_bar_and_one_does_not(hd, mode):
    """At N(0, 1) inputs the split products stay within the fp32 bar
    (2e-5 + 2e-5 |plain|) of ``flash_attention_plain``; a single TF32
    product per matrix product does not."""
    q, k, v, qp, kp = _attn_inputs(2, 24, 80, 8, 2, hd, torch.float32,
                                   torch.device("cpu"), seed=hd)
    kw = dict(mode=mode, window=30)
    ref = fa.flash_attention_plain(q, k, v, qp, kp, **kw)
    limit = 2e-5 + 2e-5 * ref.abs()
    three = _attention_tf32(q, k, v, qp, kp, mode, 30, parts=3)
    one = _attention_tf32(q, k, v, qp, kp, mode, 30, parts=1)
    assert bool(((three - ref).abs() <= limit).all()), \
        float((three - ref).abs().max())
    assert bool(((one - ref).abs() > limit).any())
    assert float((one - ref).abs().max()) > 5 * float(
        (three - ref).abs().max())
