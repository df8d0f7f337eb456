"""Flash attention with GQA and position masks: the Hopper kernels, their
wrappers and their plain PyTorch versions.

The kernels in ``csrc/flash_attention.cu`` replace the TPU kernel
``src/repro/kernels/flash_attention.py::_flash_kernel``. They read q
(B, Sq, H, hd) and k, v (B, Skv, KV, hd) in that layout through their
strides, walk KV tiles with an fp32 online softmax, and mask by explicit
positions (``kv_pos = -1`` is an empty slot), for the modes causal, sliding
(``window``), chunked_local (``window``) and cross. A masked probability is
0, so a query row with no admissible key gives 0 — as the Pallas kernel
does, and unlike ``models.attention.chunked_attention``, which gives the
mean of V on such a row. The model path never makes one: a query always
sees its own fresh key.

The keys may come from two sources, read in place: ``k, v, kv_pos`` (a KV
cache) and ``k2, v2, kv_pos2`` (the fresh chunk). Attention then runs over
their concatenation along the sequence axis, which is the reference's
semantics (same keys, same order) without the copy.

Route, from the dtype and the shape only (rows = Sq * G, the query rows
that share one KV head):

* rows <= ``SPLIT_MAX_ROWS`` (decode): ``flash_split_kernel`` writes fp32
  partials (m, l, acc) for ``default_splits`` ranges of KV tiles, and
  ``flash_combine_kernel`` merges them (any dtype); one launcher call
  starts both;
* otherwise bf16: ``flash_mma_kernel`` (tensor cores, mma.sync);
* otherwise fp32: ``flash_tf32_kernel`` (tensor cores, both products as
  3xTF32: each fp32 operand split into two TF32 parts, three mma.sync per
  product, held to the fp32 bar).

K/V tiles are copied 16 bytes at a time where every base pointer and
stride is 16-byte aligned and hd is a multiple of 16 bytes, and element by
element otherwise; the wrapper checks which and never pads.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises (a failed build or a refused launch never
falls back). A ``meta`` tensor (the dry run's shapes without storage)
takes the plain version's path too: it computes shapes only, so there is
no value a kernel could have given instead. ``LAUNCHES`` counts kernel launches per kernel (never
plain-version calls).

Gradients. Where autograd needs one (grad enabled and q, k or v requiring
it), ``flash_attention`` goes through ``FlashAttention``, an autograd
Function: its forward is the same route (the kernel on the card, the plain
version on the CPU), and its backward, ``flash_attention_backward``,
computes dq, dk and dv in PyTorch ops over chunks of ``grad_chunk`` keys.
It recomputes the scores and each row's log-sum-exp in fp32 with the same
masks (an empty slot or a fully masked row gives no gradient) and returns
q, k and v's dtypes. The reference has no backward kernel: it trains
through the jnp ``chunked_attention`` and lets XLA differentiate it. So
this backward is the counterpart of that XLA gradient, as the projections
are left to cuBLAS; it is not the plain version of a kernel. Serving
(``torch.no_grad``) never enters the Function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.models.attention import NEG_INF, _mode_mask

LAUNCHES = {"flash_tf32": 0, "flash_mma": 0, "flash_split": 0,
            "flash_combine": 0}
MODES = {"causal": 0, "sliding": 1, "chunked_local": 2, "cross": 3}
ROUTES = {"tf32": 0, "mma": 1, "split": 2}
MAX_HEAD_DIM = 256
SPLIT_MAX_ROWS = 8        # rows = Sq * G at or below which decode splits KV
SPLIT_TILE = 32           # keys per tile of flash_split_kernel
# splits are chosen so that ~4 blocks per SM of an H100 (132 SMs) are busy
SPLIT_TARGET_BLOCKS = 4 * 132
MAX_SPLITS = 64
# devices whose tensors take the plain versions: the CPU, and meta (shapes
# only)
PLAIN_DEVICES = ("cpu", "meta")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def select_route(dtype: torch.dtype, sq: int, g: int) -> str:
    """The kernel a CUDA call goes to: "split" (then the combine), "mma"
    (bf16) or "tf32" (fp32)."""
    if sq * g <= SPLIT_MAX_ROWS:
        return "split"
    return "mma" if dtype == torch.bfloat16 else "tf32"


def default_splits(b: int, kvh: int, skv: int) -> int:
    """Splits of the KV tiles at decode: enough blocks (B * KV * splits)
    to reach ``SPLIT_TARGET_BLOCKS``, at most one per tile."""
    tiles = max(1, -(-skv // SPLIT_TILE))
    want = -(-SPLIT_TARGET_BLOCKS // max(1, b * kvh))
    return max(1, min(want, tiles, MAX_SPLITS))


def tiles_per_split(skv: int, splits: int) -> int:
    """Split s covers KV tiles [s * tps, (s + 1) * tps) of SPLIT_TILE keys;
    splits past the end are empty."""
    tiles = -(-skv // SPLIT_TILE)
    return max(1, -(-tiles // splits))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _concat(k, v, kv_pos, k2, v2, kv_pos2):
    if k2 is None:
        return k, v, kv_pos
    return (torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1),
            torch.cat([kv_pos, kv_pos2], dim=1))


def _online_softmax(q, k, v, q_pos, kv_pos, mode, window, kv_chunk):
    """Unnormalised (m, l, acc) of the kernel's online softmax over all of
    k: (B, Sq, KV, G) and (B, Sq, KV, G, hd), in fp32."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float() * hd ** -0.5
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    for start in range(0, skv, kv_chunk):
        sl = slice(start, min(start + kv_chunk, skv))
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, k[:, sl].float())
        mask = _mode_mask(mode, q_pos, kv_pos[:, sl], window)
        mask = mask[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p, v[:, sl].float())
        m = m_new
    return m, l, acc


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, mode: str,
                          window: int = 0, kv_chunk: int = 512, k2=None,
                          v2=None, kv_pos2=None) -> torch.Tensor:
    """Plain version of the kernels: an online softmax over KV chunks in
    fp32 with the kernels' masking (p = 0 where masked), over the
    concatenation of the sources. It equals the Pallas kernel everywhere
    and ``chunked_attention`` on every row that has at least one admissible
    key."""
    k, v, kv_pos = _concat(k, v, kv_pos, k2, v2, kv_pos2)
    b, sq, h, hd = q.shape
    _, l, acc = _online_softmax(q, k, v, q_pos, kv_pos, mode, window,
                                kv_chunk)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_split_plain(q, k, v, q_pos, kv_pos, *, mode: str, window: int = 0,
                      splits: int, k2=None, v2=None, kv_pos2=None):
    """Plain version of ``flash_split_kernel``: per split s (keys
    [s tps T, (s + 1) tps T), T = SPLIT_TILE), the unnormalised (m, l, acc)
    in the kernel's layout: m, l (B, KV, splits, Sq * G) and acc
    (B, KV, splits, Sq * G, hd), rows ordered (query, group member). A
    split with no admissible slot has m = -1e30, l = 0, acc = 0."""
    k, v, kv_pos = _concat(k, v, kv_pos, k2, v2, kv_pos2)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    per = tiles_per_split(skv, splits) * SPLIT_TILE
    ms, ls, accs = [], [], []
    for s in range(splits):
        sl = slice(min(s * per, skv), min((s + 1) * per, skv))
        m, l, acc = _online_softmax(q, k[:, sl], v[:, sl], q_pos,
                                    kv_pos[:, sl], mode, window,
                                    max(1, sl.stop - sl.start))
        ms.append(m.permute(0, 2, 1, 3).reshape(b, kvh, sq * g))
        ls.append(l.permute(0, 2, 1, 3).reshape(b, kvh, sq * g))
        accs.append(acc.permute(0, 2, 1, 3, 4).reshape(b, kvh, sq * g, hd))
    return (torch.stack(ms, dim=2), torch.stack(ls, dim=2),
            torch.stack(accs, dim=2))


def flash_combine_plain(part_m, part_l, part_acc, *, sq: int,
                        dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``flash_combine_kernel``: M = max over splits,
    w = exp(m - M), out = sum w acc / max(sum w l, 1e-30), rounded once to
    ``dtype``. Returns (B, Sq, H, hd)."""
    b, kvh, _, rows, hd = part_acc.shape
    g = rows // sq
    mm = torch.amax(part_m, dim=2, keepdim=True)
    w = torch.exp(part_m - mm)
    l = torch.sum(w * part_l, dim=2)
    acc = torch.sum(w[..., None] * part_acc, dim=2)
    out = acc / torch.clamp(l, min=1e-30)[..., None]       # (B, KV, R, hd)
    out = out.reshape(b, kvh, sq, g, hd).permute(0, 2, 1, 3, 4)
    return out.reshape(b, sq, kvh * g, hd).to(dtype)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(q, k, v, q_pos, kv_pos, mode, window, compute_dtype, k2, v2,
           kv_pos2) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown attention mode: {mode}")
    if mode in ("sliding", "chunked_local") and window <= 0:
        raise ValueError(f"flash_attention: mode {mode} needs window > 0, "
                         f"got {window}")
    if compute_dtype != "float32":
        raise ValueError("flash_attention computes scores and P.V in fp32; "
                         f"compute_dtype={compute_dtype!r} is not supported")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-d "
                         "(B, S, heads, hd)")
    b, sq, h, hd = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads is not a "
                         f"multiple of {kvh} KV heads")
    if tuple(q_pos.shape) != (b, sq) or tuple(kv_pos.shape) != (b, k.shape[1]):
        raise ValueError("flash_attention: q_pos must be (B, Sq) and kv_pos "
                         "(B, Skv)")
    if q_pos.dtype != torch.int32 or kv_pos.dtype != torch.int32:
        raise TypeError("flash_attention: positions must be int32")
    given = [t is not None for t in (k2, v2, kv_pos2)]
    if any(given) and not all(given):
        raise ValueError("flash_attention: k2, v2 and kv_pos2 go together")
    if all(given):
        if k2.dim() != 4 or k2.shape != v2.shape or k2.shape[0] != b or \
                k2.shape[2:] != k.shape[2:]:
            raise ValueError(f"flash_attention: k2 {tuple(k2.shape)} and v2 "
                             f"{tuple(v2.shape)} do not match k "
                             f"{tuple(k.shape)}")
        if tuple(kv_pos2.shape) != (b, k2.shape[1]):
            raise ValueError("flash_attention: kv_pos2 must be (B, Skv2)")
        if kv_pos2.dtype != torch.int32:
            raise TypeError("flash_attention: positions must be int32")


_KV_NAMES = ("k", "v", "k2", "v2")
_POS_NAMES = ("q_pos", "kv_pos", "kv_pos2")


def _cuda_inputs(name, q, kv, pos) -> None:
    """kv: (k, v) or (k, v, k2, v2); pos: (q_pos, kv_pos[, kv_pos2])."""
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != dtype for t in kv):
        raise TypeError(f"{name}: q, k, v must share one dtype, float32 or "
                        "bfloat16 (got "
                        + ", ".join(str(t.dtype) for t in (q, *kv)) + ")")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")
    for key, t in zip(("q",) + _KV_NAMES, (q, *kv)):
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, want {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: {key}'s last dim is not contiguous")
    for key, t in zip(_POS_NAMES, pos):
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, want {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: positions must be contiguous")


def _vec16(ptrs, strides, hd: int, item: int) -> bool:
    per = 16 // item
    return hd % per == 0 and all(p % 16 == 0 for p in ptrs) and all(
        s % per == 0 for s in strides)


def vec16_ok(tensors, hd: int) -> bool:
    """Whether 16-byte copies can read every row of ``tensors``: hd, each
    base pointer and each stride a multiple of 16 bytes."""
    return _vec16([t.data_ptr() for t in tensors],
                  [s for t in tensors for s in t.stride()[:3]], hd,
                  tensors[0].element_size())


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(route, q, kv, pos, out, mode, window, splits=1, part=None):
    """One call of ``flash_attention_launch``. Split route: the partials go
    to ``part`` (one fp32 buffer: m, l, acc), and the combine kernel
    follows on the same stream when ``out`` is given."""
    b, sq, h, hd = q.shape
    k = kv[0]
    kvh = k.shape[2]
    o = q if out is None else out     # out's strides are unused without it
    strides = [*q.stride()[:3], *o.stride()[:3]]
    kv_strides = [s for t in kv for s in t.stride()[:3]]
    ptrs = [t.data_ptr() for t in (q, *kv)]
    vec = _vec16(ptrs, [*strides[:3], *kv_strides], hd, q.element_size())
    if len(kv) == 4:
        src2 = (ptrs[3], ptrs[4], pos[2].data_ptr(), kv[2].shape[1])
    else:
        kv_strides += [0] * 6
        src2 = (None, None, None, 0)
    skv = k.shape[1] + src2[3]
    from repro_torch.kernels import build
    rc = build.load("flash_attention").flash_attention_launch(
        ROUTES[route], ptrs[0], pos[0].data_ptr(),
        None if out is None else out.data_ptr(), ptrs[1], ptrs[2],
        pos[1].data_ptr(), k.shape[1], *src2,
        (ctypes.c_longlong * 18)(*strides, *kv_strides), b, sq, kvh,
        h // kvh, hd, MODES[mode], int(window), float(hd ** -0.5),
        int(q.dtype == torch.bfloat16), int(vec), splits,
        tiles_per_split(skv, splits),
        None if part is None else part.data_ptr(), _stream(q.device))
    if rc != 0:
        kernels = ("flash_split_kernel and flash_combine_kernel"
                   if route == "split" and out is not None
                   else f"flash_{route}_kernel")
        raise RuntimeError(f"{kernels} launch failed: CUDA error {rc}")
    LAUNCHES[f"flash_{route}"] += 1
    if route == "split" and out is not None:
        LAUNCHES["flash_combine"] += 1


def _part_buffer(q, kvh, splits):
    b, sq, h, hd = q.shape
    n = b * kvh * splits * sq * (h // kvh)
    return torch.empty((n * (2 + hd),), dtype=torch.float32, device=q.device)


def flash_split(q, k, v, q_pos, kv_pos, *, mode: str, window: int = 0,
                splits: int, k2=None, v2=None, kv_pos2=None):
    """Split-KV partials (m, l, acc) in the layout of ``flash_split_plain``
    (Sq * G <= SPLIT_MAX_ROWS, 1 <= splits <= MAX_SPLITS)."""
    _check(q, k, v, q_pos, kv_pos, mode, window, "float32", k2, v2, kv_pos2)
    kw = dict(mode=mode, window=window, splits=splits, k2=k2, v2=v2,
              kv_pos2=kv_pos2)
    if q.device.type in PLAIN_DEVICES:
        return flash_split_plain(q, k, v, q_pos, kv_pos, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_split: unsupported device {q.device}")
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    rows = sq * (h // kvh)
    if rows > SPLIT_MAX_ROWS:
        raise ValueError(f"flash_split: {rows} rows per KV head > "
                         f"{SPLIT_MAX_ROWS}")
    if not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"flash_split: splits must be in [1, {MAX_SPLITS}]"
                         f", got {splits}")
    kv, pos = _sources(k, v, q_pos, kv_pos, k2, v2, kv_pos2)
    _cuda_inputs("flash_split", q, kv, pos)
    buf = _part_buffer(q, kvh, splits)
    _launch("split", q, kv, pos, None, mode, window, splits, buf)
    n = b * kvh * splits * rows
    return (buf[:n].view(b, kvh, splits, rows),
            buf[n:2 * n].view(b, kvh, splits, rows),
            buf[2 * n:].view(b, kvh, splits, rows, hd))


def flash_combine(part_m, part_l, part_acc, *, sq: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """Merge split-KV partials into (B, Sq, H, hd) of ``dtype``."""
    dev = part_acc.device
    if dev.type in PLAIN_DEVICES:
        return flash_combine_plain(part_m, part_l, part_acc, sq=sq,
                                   dtype=dtype)
    if dev.type != "cuda":
        raise ValueError(f"flash_combine: unsupported device {dev}")
    b, kvh, splits, rows, hd = part_acc.shape
    for name, t, shape in (("part_m", part_m, (b, kvh, splits, rows)),
                           ("part_l", part_l, (b, kvh, splits, rows)),
                           ("part_acc", part_acc, tuple(part_acc.shape))):
        if t.device != dev or t.dtype != torch.float32 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"flash_combine: {name} must be a contiguous "
                             f"fp32 {shape} tensor on {dev}")
    if rows % sq or dtype not in (torch.float32, torch.bfloat16) or \
            not 1 <= splits <= MAX_SPLITS:
        raise ValueError("flash_combine: rows must be Sq * G, dtype fp32 or "
                         f"bf16 and splits in [1, {MAX_SPLITS}]")
    g = rows // sq
    out = torch.empty((b, sq, kvh * g, hd), dtype=dtype, device=dev)
    from repro_torch.kernels import build
    rc = build.load("flash_attention").flash_combine_launch(
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
        out.data_ptr(), out.stride(0), out.stride(1), out.stride(2), b, kvh,
        sq, g, hd, splits, int(dtype == torch.bfloat16), _stream(dev))
    if rc != 0:
        raise RuntimeError(f"flash_combine_kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES["flash_combine"] += 1
    return out


def _sources(k, v, q_pos, kv_pos, k2, v2, kv_pos2):
    if k2 is None:
        return (k, v), (q_pos, kv_pos)
    return (k, v, k2, v2), (q_pos, kv_pos, kv_pos2)


def flash_attention(q, k, v, q_pos, kv_pos, *, mode: str, window: int = 0,
                    compute_dtype: str = "float32", k2=None, v2=None,
                    kv_pos2=None, grad_chunk: int = 512) -> torch.Tensor:
    """GQA flash attention.

    Args:
      q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H = G * KV, hd <= 256,
        fp32 or bf16 (one dtype for all), last dim contiguous.
      q_pos: (B, Sq) int32; kv_pos: (B, Skv) int32, -1 = empty slot.
      mode: causal | sliding | chunked_local | cross; ``window`` is read by
        sliding and chunked_local only.
      compute_dtype: must be "float32" (the math of both products).
      k2, v2, kv_pos2: an optional second source (B, Skv2, KV, hd) and
        (B, Skv2); the keys are then [k ; k2], read in place.
      grad_chunk: keys per chunk of the backward (``FlashAttention``).

    On the card the route is ``select_route(dtype, Sq, G)``; the split
    route uses ``default_splits`` splits and launches the split kernel and
    the combine kernel in one call. Where a gradient is needed the call
    goes through ``FlashAttention`` (one source only).

    Returns (B, Sq, H, hd) in q's dtype.
    """
    _check(q, k, v, q_pos, kv_pos, mode, window, compute_dtype, k2, v2,
           kv_pos2)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if k2 is not None:
            raise ValueError("flash_attention: a gradient is computed for "
                             "one key source only (k2 is the decode path)")
        return FlashAttention.apply(q, k, v, q_pos, kv_pos, mode, window,
                                    grad_chunk)
    return _forward(q, k, v, q_pos, kv_pos, mode, window, k2, v2, kv_pos2)


def _forward(q, k, v, q_pos, kv_pos, mode, window, k2=None, v2=None,
             kv_pos2=None) -> torch.Tensor:
    """The forward route: the plain version on the CPU, the kernels on the
    card (inputs already checked)."""
    dev = q.device
    if dev.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, q_pos, kv_pos, mode=mode,
                                     window=window, k2=k2, v2=v2,
                                     kv_pos2=kv_pos2)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    kv, pos = _sources(k, v, q_pos, kv_pos, k2, v2, kv_pos2)
    _cuda_inputs("flash_attention", q, kv, pos)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    if q.numel() == 0:
        return out
    route = select_route(q.dtype, sq, h // kvh)
    if route == "split":
        skv = k.shape[1] + (0 if k2 is None else k2.shape[1])
        splits = default_splits(b, kvh, skv)
        _launch(route, q, kv, pos, out, mode, window, splits,
                _part_buffer(q, kvh, splits))
    else:
        _launch(route, q, kv, pos, out, mode, window)
    return out


# ---------------------------------------------------------------------------
# gradient
# ---------------------------------------------------------------------------

class FlashAttention(torch.autograd.Function):
    """Autograd of ``flash_attention`` (one key source): the forward is the
    kernel route (the plain version on the CPU), the backward
    ``flash_attention_backward``. Saves q, k, v, the positions and the
    output."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, mode, window, grad_chunk):
        out = _forward(q, k, v, q_pos, kv_pos, mode, window)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, out)
        ctx.mode, ctx.window, ctx.grad_chunk = mode, window, grad_chunk
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(
            q, k, v, q_pos, kv_pos, out, dout.contiguous(), mode=ctx.mode,
            window=ctx.window, kv_chunk=ctx.grad_chunk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_backward(q, k, v, q_pos, kv_pos, out, dout, *,
                             mode: str, window: int = 0,
                             kv_chunk: int = 512):
    """dq, dk, dv of ``flash_attention`` at ``dout``, in fp32 PyTorch ops
    over chunks of ``kv_chunk`` keys, two passes: the row log-sum-exp
    first, then per chunk P = exp(S - lse) (0 where masked),
    dV = P^T dO, dS = P (dO V^T - rowsum(dO * O)), dQ = dS K, dK = dS^T Q
    (the 1/sqrt(hd) scale on both). Returns q, k and v's dtypes."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    qg = q.reshape(b, sq, kvh, g, hd).float() * scale
    chunks = [slice(s, min(s + kv_chunk, skv)) for s in range(0, skv,
                                                               kv_chunk)]

    def scores(sl):
        mask = _mode_mask(mode, q_pos, kv_pos[:, sl], window)[:, :, None,
                                                              None, :]
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, k[:, sl].float())
        return torch.where(mask, s, NEG_INF), mask

    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    for sl in chunks:
        s, mask = scores(sl)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * torch.exp(m - m_new) + torch.sum(p, dim=-1)
        m = m_new
    lse = torch.where(l > 0, m + torch.log(torch.clamp(l, min=1e-30)), 0.0)
    do = dout.reshape(b, sq, kvh, g, hd).float()
    delta = torch.sum(do * out.reshape(b, sq, kvh, g, hd).float(), dim=-1)
    dqg = torch.zeros_like(qg)
    dk = torch.empty((b, skv, kvh, hd), dtype=torch.float32,
                     device=q.device)
    dv = torch.empty_like(dk)
    for sl in chunks:
        s, mask = scores(sl)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        vc = v[:, sl].float()
        dv[:, sl] = torch.einsum("bqkgc,bqkgh->bckh", p, do)
        ds = p * (torch.einsum("bqkgh,bckh->bqkgc", do, vc)
                  - delta[..., None])
        dqg += torch.einsum("bqkgc,bckh->bqkgh", ds, k[:, sl].float())
        dk[:, sl] = torch.einsum("bqkgc,bqkgh->bckh", ds, qg)
    dq = (dqg * scale).reshape(b, sq, h, hd)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
