"""Flash-style attention in plain PyTorch: the reference's oracles.

Counterpart of ``repro.models.attention``. The four variants of the zoo

  * ``causal``         — standard autoregressive attention
  * ``sliding``        — sliding-window (h2o-danube3, zamba2 long mode)
  * ``chunked_local``  — non-overlapping local chunks (llama4 iRoPE-style)
  * ``cross``          — encoder-decoder cross attention (no causal mask)

are expressed through explicit positions: a KV slot is attendable iff its
position is valid (>= 0) and the mode's positional predicate admits it.

The model path does not call these: ``repro_torch.models.blocks._attention``
goes to ``repro_torch.kernels.flash_attention`` (the Hopper kernels on the
card, their plain version on the CPU). They are kept as the twins of the
reference's ``chunked_attention`` and ``reference_attention``. On a query row
with no admissible key both give the mean of V (every masked score is
NEG_INF, so the softmax is uniform), where the kernel gives 0.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _mode_mask(mode: str, q_pos: torch.Tensor, kv_pos: torch.Tensor,
               window: int) -> torch.Tensor:
    """(..., Sq, Skv) boolean mask from positions."""
    q = q_pos[..., :, None]
    k = kv_pos[..., None, :]
    valid = k >= 0  # negative position = empty cache slot
    if mode == "causal":
        return valid & (k <= q)
    if mode == "sliding":
        return valid & (k <= q) & (k > q - window)
    if mode == "chunked_local":
        return valid & (k <= q) & (torch.div(k, window, rounding_mode="floor")
                                   == torch.div(q, window,
                                                rounding_mode="floor"))
    if mode == "cross":
        return valid
    raise ValueError(f"unknown attention mode: {mode}")


def chunked_attention(q, k, v, q_pos, kv_pos, *, mode: str, window: int = 0,
                      kv_chunk: int = 512,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """GQA attention as a loop over KV chunks with a running log-sum-exp.

    Args:
      q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H = G * KV.
      q_pos: (B, Sq) int32 absolute positions of the queries.
      kv_pos: (B, Skv) int32 positions of KV slots; -1 marks empty slots.
      kv_chunk: KV block size of the loop.
      compute_dtype: operand dtype of both products (accumulation in fp32).

    Returns:
      (B, Sq, H, hd) attention output in q.dtype.
    """
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = hd ** -0.5
    cdt = getattr(torch, compute_dtype)
    qg = (q.reshape(b, sq, kvh, g, hd).float() * scale).to(cdt)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    # the reference pads the last chunk with masked keys (position -1, zero
    # V); they add exp(NEG_INF - m) to l, which counts on a row that has no
    # admissible key
    n_chunks = -(-skv // kv_chunk)
    for c in range(n_chunks):
        sl = slice(c * kv_chunk, min((c + 1) * kv_chunk, skv))
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, k[:, sl].to(cdt)).float()
        mask = _mode_mask(mode, q_pos, kv_pos[:, sl], window)
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        pad = kv_chunk - s.shape[-1]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        p_sum = torch.sum(p, dim=-1)
        if pad:  # padded slots: exp(NEG_INF - m_new) each
            p_sum = p_sum + pad * torch.exp(NEG_INF - m_new)
        l = l * alpha + p_sum
        acc = acc * alpha[..., None] + torch.einsum(
            "bqkgc,bckh->bqkgh", p.to(cdt), v[:, sl].to(cdt)).float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


def reference_attention(q, k, v, q_pos, kv_pos, *, mode: str,
                        window: int = 0) -> torch.Tensor:
    """Naive O(Sq*Skv) oracle."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, hd).float()
    s = torch.einsum("bqkgh,bckh->bqkgc", qg, k.float()) * hd ** -0.5
    mask = _mode_mask(mode, q_pos, kv_pos, window)
    s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqkgc,bckh->bqkgh", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
