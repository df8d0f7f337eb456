"""Flash attention with GQA and position masks: the Hopper kernel, its
wrapper and its plain PyTorch version.

Kernel ``flash_attention_kernel`` in ``csrc/flash_attention.cu`` replaces
the TPU kernel ``src/repro/kernels/flash_attention.py::_flash_kernel``. It
reads q (B, Sq, H, hd) and k, v (B, Skv, KV, hd) in that layout through
their strides, walks KV tiles with an fp32 online softmax, and masks by
explicit positions (``kv_pos = -1`` is an empty slot), for the modes
causal, sliding (``window``), chunked_local (``window``) and cross. A masked
probability is 0, so a query row with no admissible key gives 0 — as the
Pallas kernel does, and unlike ``models.attention.chunked_attention``, which
gives the mean of V on such a row. The model path never makes one: a query
always sees its own fresh key.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. ``LAUNCHES["flash_attention"]`` counts kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import NEG_INF, _mode_mask

LAUNCHES = {"flash_attention": 0}
MODES = {"causal": 0, "sliding": 1, "chunked_local": 2, "cross": 3}
MAX_HEAD_DIM = 256


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def flash_attention_plain(q, k, v, q_pos, kv_pos, *, mode: str,
                          window: int = 0,
                          kv_chunk: int = 512) -> torch.Tensor:
    """Plain version of the kernel: an online softmax over KV chunks in
    fp32 with the kernel's masking (p = 0 where masked). It equals the
    Pallas kernel everywhere and ``chunked_attention`` on every row that has
    at least one admissible key."""
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
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _check(q, k, v, q_pos, kv_pos, mode, window, compute_dtype) -> None:
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


def flash_attention(q, k, v, q_pos, kv_pos, *, mode: str, window: int = 0,
                    compute_dtype: str = "float32") -> torch.Tensor:
    """GQA flash attention.

    Args:
      q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H = G * KV, hd <= 256,
        fp32 or bf16 (one dtype for all three), last dim contiguous.
      q_pos: (B, Sq) int32; kv_pos: (B, Skv) int32, -1 = empty slot.
      mode: causal | sliding | chunked_local | cross; ``window`` is read by
        sliding and chunked_local only.
      compute_dtype: must be "float32" (the math of both products).

    Returns (B, Sq, H, hd) in q's dtype.
    """
    _check(q, k, v, q_pos, kv_pos, mode, window, compute_dtype)
    dev = q.device
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, q_pos, kv_pos, mode=mode,
                                     window=window)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, t in (("k", k), ("v", v), ("q_pos", q_pos),
                    ("kv_pos", kv_pos)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             f"want {dev}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16 (got {q.dtype}, {k.dtype}, "
                        f"{v.dtype})")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {hd} > {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim is not "
                             "contiguous")
    if not (q_pos.is_contiguous() and kv_pos.is_contiguous()):
        raise ValueError("flash_attention: positions must be contiguous")
    out = torch.empty((b, sq, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    from repro_torch.kernels import build
    lib = build.load("flash_attention")
    rc = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        kv_pos.data_ptr(), out.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        b, sq, skv, kvh, h // kvh, hd, MODES[mode], int(window),
        int(q.dtype == torch.bfloat16), float(hd ** -0.5),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention_kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES["flash_attention"] += 1
    return out
