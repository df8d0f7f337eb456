"""The port's attention against the JAX reference on the CPU.

* The flash kernel's plain version (what ``kernels.flash_attention`` runs
  for CPU tensors) against the reference's Pallas kernel in interpret mode
  (``repro.kernels.flash_attention.flash_attention``), in all four modes,
  at the tolerances of ``tests/test_kernels.py``: 2e-5 in fp32, 3e-2 in
  bf16 (atol and rtol), fully masked rows included.
* Against ``chunked_attention`` and ``reference_attention`` (the model
  path's math and the naive oracle) on inputs where every query row has an
  admissible key, at 2e-5.
* The port's own ``chunked_attention`` / ``reference_attention`` against
  the reference's, including a fully masked row (mean of V in both).

Inputs are made with numpy from a seed; bf16 inputs are the fp32 draws
rounded to bf16 by each framework (both round to nearest even).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import attention as jatt
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops
from repro_torch.models import attention as tatt
from repro_torch.models.attention import NEG_INF

TOL = {"float32": 2e-5, "bfloat16": 3e-2}

# (b, sq, skv, h, kvh, hd, mode, window) — the cases of tests/test_kernels.py
ATTN_CASES = [
    (2, 32, 32, 4, 2, 16, "causal", 0),
    (2, 32, 32, 4, 2, 16, "sliding", 8),
    (2, 32, 32, 4, 4, 16, "chunked_local", 8),
    (2, 8, 24, 4, 2, 16, "cross", 0),
    (1, 1, 40, 8, 2, 32, "causal", 0),      # decode shape
    (2, 17, 23, 8, 2, 32, "causal", 0),     # non-multiples of block
    (1, 64, 64, 2, 1, 64, "sliding", 16),
    (3, 5, 37, 6, 3, 8, "chunked_local", 4),
]


def _inputs(b, sq, skv, h, kvh, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    q_pos = np.tile(np.arange(skv - sq, skv), (b, 1)).astype(np.int32)
    kv_pos = np.tile(np.arange(skv), (b, 1)).astype(np.int32)
    return q, k, v, q_pos, kv_pos


def _jax(arrs, dtype):
    q, k, v, qp, kp = arrs
    jd = getattr(jnp, dtype)
    return (jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
            jnp.asarray(qp), jnp.asarray(kp))


def _torch(arrs, dtype):
    q, k, v, qp, kp = arrs
    td = getattr(torch, dtype)
    return (torch.as_tensor(q).to(td), torch.as_tensor(k).to(td),
            torch.as_tensor(v).to(td), torch.as_tensor(qp),
            torch.as_tensor(kp))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(a, b, tol):
    np.testing.assert_allclose(_f32(a), _f32(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(case, dtype):
    b, sq, skv, h, kvh, hd, mode, window = case
    arrs = _inputs(b, sq, skv, h, kvh, hd, seed=sum(case[:6]))
    out_j = pallas_flash(*_jax(arrs, dtype), mode=mode, window=window,
                         block_q=16, block_kv=16, interpret=True)
    out_t = tfa.flash_attention(*_torch(arrs, dtype), mode=mode,
                                window=window)
    assert out_t.dtype == getattr(torch, dtype)
    assert out_t.shape == (b, sq, h, hd)
    _close(out_t, out_j, TOL[dtype])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_plain_matches_chunked_and_reference(case):
    b, sq, skv, h, kvh, hd, mode, window = case
    arrs = _inputs(b, sq, skv, h, kvh, hd, seed=7 + sum(case[:6]))
    out_t = tfa.flash_attention(*_torch(arrs, "float32"), mode=mode,
                                window=window)
    jin = _jax(arrs, "float32")
    _close(out_t, jatt.chunked_attention(*jin, mode=mode, window=window,
                                         kv_chunk=16), 2e-5)
    _close(out_t, jatt.reference_attention(*jin, mode=mode, window=window),
           2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_buffer_positions_match_pallas(dtype):
    """Rotated (ring-buffer) kv_pos with empty (-1) slots, sliding mode."""
    b, skv, kvh, hd = 2, 24, 2, 16
    q, k, v, _, _ = _inputs(b, 1, skv, 4, kvh, hd, seed=1)
    kv_pos = np.tile((np.arange(skv) + 7) % skv, (b, 1)).astype(np.int32)
    kv_pos[:, -4:] = -1
    q_pos = np.full((b, 1), skv + 2, np.int32)
    arrs = (q, k, v, q_pos, kv_pos)
    out_j = pallas_flash(*_jax(arrs, dtype), mode="sliding", window=10,
                         block_q=8, block_kv=8, interpret=True)
    out_t = tfa.flash_attention(*_torch(arrs, dtype), mode="sliding",
                                window=10)
    _close(out_t, out_j, TOL[dtype])
    if dtype == "float32":
        _close(out_t, jatt.reference_attention(
            *_jax(arrs, dtype), mode="sliding", window=10), 2e-5)


# G = H / KV in {1, 2, 4}, ragged Sq and Skv, hd in {8, 24, 64}
SWEEP = [(g, sq, skv, hd, mode)
         for g, sq, skv in ((1, 3, 29), (2, 13, 13), (4, 1, 47), (4, 21, 50))
         for hd, mode in ((8, "causal"), (24, "sliding"),
                          (64, "chunked_local"))]


@pytest.mark.parametrize("g,sq,skv,hd,mode", SWEEP)
def test_plain_matches_pallas_sweep(g, sq, skv, hd, mode):
    kvh = 2
    arrs = _inputs(1, sq, skv, kvh * g, kvh, hd, seed=g * 100 + skv + hd)
    window = 6
    out_j = pallas_flash(*_jax(arrs, "float32"), mode=mode, window=window,
                         block_q=16, block_kv=16, interpret=True)
    out_t = tfa.flash_attention(*_torch(arrs, "float32"), mode=mode,
                                window=window)
    _close(out_t, out_j, 2e-5)


def _fully_masked_inputs():
    """Batch row 0: every slot empty (-1). Batch row 1: the first query sits
    before every key (causal: nothing admissible), the rest see keys."""
    b, sq, skv, h, kvh, hd = 2, 4, 20, 4, 2, 16
    q, k, v, _, _ = _inputs(b, sq, skv, h, kvh, hd, seed=11)
    kv_pos = np.stack([np.full(skv, -1), np.arange(10, 10 + skv)]
                      ).astype(np.int32)
    q_pos = np.stack([np.arange(20, 24), np.array([5, 12, 20, 29])]
                     ).astype(np.int32)
    return q, k, v, q_pos, kv_pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fully_masked_rows_give_zero_like_pallas(dtype):
    arrs = _fully_masked_inputs()
    out_t = tfa.flash_attention(*_torch(arrs, dtype), mode="causal")
    out_j = pallas_flash(*_jax(arrs, dtype), mode="causal", block_q=8,
                         block_kv=8, interpret=True)
    _close(out_t, out_j, TOL[dtype])
    # The Pallas kernel zeroes masked probabilities
    # (src/repro/kernels/flash_attention.py:74), so a row with no admissible
    # key gives 0; the port's kernel and plain version follow it.
    assert float(out_t[0].abs().max()) == 0.0
    assert float(out_t[1, 0].abs().max()) == 0.0
    assert float(out_t[1, 1:].abs().max()) > 0.0


def test_fully_masked_rows_differ_from_chunked_attention():
    """``chunked_attention`` (src/repro/models/attention.py:98) does not
    zero masked probabilities: exp(NEG_INF - NEG_INF) = 1, so a row with no
    admissible key averages V (over the padded chunk, whose padded slots
    add 1 each to l and 0 to acc). The port's twin does the same; the
    kernel gives 0. On rows with an admissible key all agree."""
    arrs = _fully_masked_inputs()
    jin, tin = _jax(arrs, "float32"), _torch(arrs, "float32")
    chunk_j = jatt.chunked_attention(*jin, mode="causal", kv_chunk=16)
    chunk_t = tatt.chunked_attention(*tin, mode="causal", kv_chunk=16)
    _close(chunk_t, chunk_j, 2e-5)
    assert float(np.abs(_f32(chunk_j)[0]).max()) > 0.1
    ref_j = jatt.reference_attention(*jin, mode="causal")
    ref_t = tatt.reference_attention(*tin, mode="causal")
    _close(ref_t, ref_j, 2e-5)
    flash = tfa.flash_attention(*tin, mode="causal")
    _close(flash[1, 1:], chunk_j[1, 1:], 2e-5)
    assert not np.allclose(_f32(flash[0]), _f32(chunk_j[0]), atol=0.1)


@pytest.mark.parametrize("case", ATTN_CASES[:4])
@pytest.mark.parametrize("kv_chunk", [7, 16, 512])
def test_port_chunked_attention_matches_reference(case, kv_chunk):
    b, sq, skv, h, kvh, hd, mode, window = case
    arrs = _inputs(b, sq, skv, h, kvh, hd, seed=3)
    jin, tin = _jax(arrs, "float32"), _torch(arrs, "float32")
    _close(tatt.chunked_attention(*tin, mode=mode, window=window,
                                  kv_chunk=kv_chunk),
           jatt.chunked_attention(*jin, mode=mode, window=window,
                                  kv_chunk=kv_chunk), 2e-5)
    _close(tatt.reference_attention(*tin, mode=mode, window=window),
           jatt.reference_attention(*jin, mode=mode, window=window), 2e-5)


def test_port_chunked_attention_bf16_operands():
    """compute_dtype="bfloat16": both products take bf16 operands and
    accumulate in fp32, as the reference's einsums do (tolerance 3e-2)."""
    arrs = _inputs(2, 16, 32, 4, 2, 16, seed=5)
    jin, tin = _jax(arrs, "float32"), _torch(arrs, "float32")
    _close(tatt.chunked_attention(*tin, mode="causal", kv_chunk=16,
                                  compute_dtype="bfloat16"),
           jatt.chunked_attention(*jin, mode="causal", kv_chunk=16,
                                  compute_dtype="bfloat16"), 3e-2)


def test_mode_mask_matches_reference():
    rng = np.random.default_rng(0)
    q_pos = rng.integers(0, 40, size=(2, 9)).astype(np.int32)
    kv_pos = rng.integers(-1, 40, size=(2, 30)).astype(np.int32)
    for mode, window in (("causal", 0), ("sliding", 5),
                         ("chunked_local", 8), ("cross", 0)):
        want = np.asarray(jatt._mode_mask(mode, jnp.asarray(q_pos),
                                          jnp.asarray(kv_pos), window))
        got = tatt._mode_mask(mode, torch.as_tensor(q_pos),
                              torch.as_tensor(kv_pos), window).numpy()
        np.testing.assert_array_equal(got, want)


def test_ops_wrapper_is_the_kernel_wrapper():
    arrs = _torch(_inputs(1, 5, 9, 4, 2, 8, seed=0), "float32")
    a = ops.flash_attention_ops(*arrs, mode="sliding", window=3)
    b = tfa.flash_attention(*arrs, mode="sliding", window=3)
    assert torch.equal(a, b)


def test_wrapper_rejects_bad_arguments():
    q, k, v, qp, kp = _torch(_inputs(1, 4, 8, 4, 2, 8, seed=0), "float32")
    with pytest.raises(ValueError, match="unknown attention mode"):
        tfa.flash_attention(q, k, v, qp, kp, mode="local")
    with pytest.raises(ValueError, match="window"):
        tfa.flash_attention(q, k, v, qp, kp, mode="chunked_local", window=0)
    with pytest.raises(ValueError, match="compute_dtype"):
        tfa.flash_attention(q, k, v, qp, kp, mode="causal",
                            compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q[:, :, :3], k, v, qp, kp, mode="causal")
    with pytest.raises(TypeError, match="int32"):
        tfa.flash_attention(q, k, v, qp.long(), kp, mode="causal")
    with pytest.raises(ValueError, match="kv_pos"):
        tfa.flash_attention(q, k, v, qp, kp[:, :5], mode="causal")


def test_plain_version_never_counts_as_a_launch():
    before = dict(tfa.LAUNCHES)
    tfa.flash_attention(*_torch(_inputs(1, 2, 5, 2, 1, 8, seed=0),
                                "float32"), mode="causal")
    assert tfa.LAUNCHES == before


# ---------------------------------------------------------------------------
# two K/V sources (cache ++ fresh chunk) and the split-KV combine
# ---------------------------------------------------------------------------

def _ring_two_sources(b, sq, cache_len, h, kvh, hd, seed):
    """A wrapped ring cache of ``cache_len`` slots (batch row 1: the first
    third empty) and ``sq`` fresh keys after it, as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, cache_len + sq, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, cache_len + sq, kvh, hd)).astype(np.float32)
    start = cache_len + 5
    ring = [start - 1 - ((start - 1 - j) % cache_len) for j in range(cache_len)]
    kv_pos = np.tile(ring + list(range(start, start + sq)), (b, 1)
                     ).astype(np.int32)
    kv_pos[1 % b, : cache_len // 3] = -1
    q_pos = np.tile(np.arange(start, start + sq), (b, 1)).astype(np.int32)
    return q, k, v, q_pos, kv_pos


def _split_sources(tin, cut):
    q, k, v, qp, kp = tin
    return (q, k[:, :cut], v[:, :cut], qp, kp[:, :cut]), dict(
        k2=k[:, cut:], v2=v[:, cut:], kv_pos2=kp[:, cut:].contiguous())


TWO_SOURCE_CASES = [
    # (b, sq, cache_len, h, kvh, hd, mode, window)
    (2, 1, 40, 8, 2, 16, "causal", 0),        # decode
    (2, 1, 37, 8, 2, 16, "sliding", 20),      # decode on a wrapped ring
    (2, 12, 37, 4, 2, 16, "sliding", 30),     # chunk: tile 32..47 straddles
    (1, 20, 45, 6, 3, 8, "chunked_local", 16),
    (2, 9, 23, 4, 4, 32, "causal", 0),
]


@pytest.mark.parametrize("case", TWO_SOURCE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_source_plain_equals_one_source(case, dtype):
    """The kernels' plain version given (cache, fresh) equals it given their
    concatenation: the same keys in the same order."""
    b, sq, cache_len, h, kvh, hd, mode, window = case
    tin = _torch(_ring_two_sources(b, sq, cache_len, h, kvh, hd, seed=1),
                 dtype)
    one = tfa.flash_attention(*tin, mode=mode, window=window)
    args, kw = _split_sources(tin, cache_len)
    two = tfa.flash_attention(*args, mode=mode, window=window, **kw)
    assert torch.equal(one, two)


@pytest.mark.parametrize("case", TWO_SOURCE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_source_plain_matches_pallas_on_concatenation(case, dtype):
    b, sq, cache_len, h, kvh, hd, mode, window = case
    arrs = _ring_two_sources(b, sq, cache_len, h, kvh, hd, seed=2)
    out_j = pallas_flash(*_jax(arrs, dtype), mode=mode, window=window,
                         block_q=8, block_kv=16, interpret=True)
    args, kw = _split_sources(_torch(arrs, dtype), cache_len)
    out_t = tfa.flash_attention(*args, mode=mode, window=window, **kw)
    _close(out_t, out_j, TOL[dtype])


def test_two_source_arguments_are_checked():
    tin = _torch(_ring_two_sources(2, 3, 10, 4, 2, 8, seed=0), "float32")
    args, kw = _split_sources(tin, 10)
    with pytest.raises(ValueError, match="together"):
        tfa.flash_attention(*args, mode="causal", k2=kw["k2"])
    with pytest.raises(ValueError, match="k2"):
        tfa.flash_attention(*args, mode="causal", k2=kw["k2"][:, :, :1],
                            v2=kw["v2"][:, :, :1], kv_pos2=kw["kv_pos2"])
    with pytest.raises(ValueError, match="kv_pos2"):
        tfa.flash_attention(*args, mode="causal", k2=kw["k2"], v2=kw["v2"],
                            kv_pos2=kw["kv_pos2"][:, :1])


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 9])
@pytest.mark.parametrize("mode,window", [("causal", 0), ("sliding", 50)])
def test_split_combine_plain_matches_unsplit(splits, mode, window):
    """The combine of per-split partials equals the unsplit plain version
    to 1e-6 in fp32, with one split whose slots are all empty (m = -1e30,
    l = 0 there)."""
    b, sq, skv, h, kvh, hd = 2, 1, 150, 8, 2, 16
    q, k, v, _, _ = _inputs(b, sq, skv, h, kvh, hd, seed=splits)
    kv_pos = np.tile(np.arange(skv), (b, 1)).astype(np.int32)
    kv_pos[:, 32:64] = -1                    # SPLIT_TILE keys 32..63 empty
    q_pos = np.full((b, sq), skv + 3, np.int32)
    tin = _torch((q, k, v, q_pos, kv_pos), "float32")
    kw = dict(mode=mode, window=window)
    want = tfa.flash_attention_plain(*tin, **kw)
    m, l, acc = tfa.flash_split_plain(*tin, splits=splits, **kw)
    assert m.shape == (b, kvh, splits, sq * h // kvh)
    assert acc.shape == (b, kvh, splits, sq * h // kvh, hd)
    per = tfa.tiles_per_split(skv, splits) * tfa.SPLIT_TILE
    empty = [s for s in range(splits)
             if s * per >= 32 and min((s + 1) * per, skv) <= 64]
    for s in empty + [s for s in range(splits) if s * per >= skv]:
        assert bool((m[:, :, s] == NEG_INF).all()) and bool((l[:, :, s] == 0).all())
    got = tfa.flash_combine(m, l, acc, sq=sq, dtype=torch.float32)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-6, rtol=1e-6)
    if mode == "causal":
        out_j = pallas_flash(*_jax((q, k, v, q_pos, kv_pos), "float32"),
                             mode=mode, block_q=1, block_kv=16,
                             interpret=True)
        _close(got, out_j, TOL["float32"])



def test_routes_and_splits_follow_dtype_and_shape():
    assert tfa.select_route(torch.bfloat16, 1, 4) == "split"
    assert tfa.select_route(torch.float32, 2, 4) == "split"
    assert tfa.select_route(torch.bfloat16, 1024, 4) == "mma"
    assert tfa.select_route(torch.float32, 1024, 4) == "tf32"
    assert tfa.select_route(torch.bfloat16, 3, 4) == "mma"
    # Qwen3-4B decode (B=8, KV=8, 1,057 keys) and Danube3 (B=2, 4,097)
    assert tfa.default_splits(8, 8, 1057) == 9
    assert tfa.default_splits(2, 8, 4097) == 33
    assert tfa.default_splits(1, 1, 40) == 2          # one per tile at most
    assert tfa.tiles_per_split(1057, 9) == 4
    assert tfa.tiles_per_split(10, 4) == 1
