"""Recurrent sequence-mixing blocks: Mamba2 (SSD), mLSTM and sLSTM
(counterpart of ``repro.models.ssm``).

* training / prefill: a **chunkwise parallel scan** for Mamba2 and mLSTM —
  attention-like products inside chunks of ``chunk`` steps, a loop over
  the chunks carrying the recurrent state (the reference's ``lax.scan``),
  so the (B, q, q, H) intra-chunk tensors exist for one chunk at a time;
* decode: the O(1)-state single-step recurrence against a carried state;
* sLSTM is a sequential scan over time in both packages (a Python loop
  here, ``lax.scan`` there).

The reference computes these in jnp, outside any Pallas kernel; this port
is plain PyTorch. Where the reference evaluates ``where(causal, exp(s),
0)`` the port masks the exponent first (``_masked_exp``): the forward is
the same, and an ``exp`` that overflows in the masked half cannot turn the
backward into ``inf * 0 = NaN``.

Parameters are dicts of tensors with the reference's names and layouts;
``*_leaves`` give shapes and initializers, as the blocks' do.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import Leaf, dense_leaf, rms_norm

# the reference's stand-in for -inf in the stabilizers and the padding
NEG_BIG = -1e30


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv. x: (B, S, C), w: (width, C).

    Returns (y, new_state); the state holds the last (width - 1) inputs for
    decode. With ``state``, x is its continuation.
    """
    width = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device)
    xx = torch.cat([state, x], dim=1)
    new_state = xx[:, -(width - 1):, :]
    y = torch.zeros_like(x)
    for i in range(width):
        y = y + xx[:, i:i + x.shape[1], :] * w[i]
    return y, new_state


def _chunk(x: torch.Tensor, q: int) -> torch.Tensor:
    """(B, S, ...) -> (n_chunks, B, q, ...); S must be divisible by q."""
    b, s = x.shape[:2]
    return torch.movedim(x.reshape(b, s // q, q, *x.shape[2:]), 1, 0)


def _pad_len(s: int, chunk: int) -> int:
    """Padding that makes s a positive multiple of chunk."""
    return (-s) % chunk if s >= chunk else chunk - s


def _pad_seq(x: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - 2) + [0, pad]   # F.pad lists the last dim first
    return F.pad(x, widths, value=value)


def _unchunk(x: torch.Tensor) -> torch.Tensor:
    n, b, q = x.shape[:3]
    return torch.movedim(x, 0, 1).reshape(b, n * q, *x.shape[3:])


def _causal(q: int, device) -> torch.Tensor:
    """(1, q_i, q_j, 1) bool: j <= i."""
    iq = torch.arange(q, device=device)
    return (iq[:, None] >= iq[None, :])[None, :, :, None]


def _masked_exp(logits: torch.Tensor, causal: torch.Tensor) -> torch.Tensor:
    """``where(causal, exp(logits), 0)`` with the exponent masked to -inf
    first: exp gives exact zeros there, with zero gradient."""
    return torch.exp(logits.masked_fill(~causal, float("-inf")))


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------

def mamba2_leaves(d_model: int, ssm_state: int, *, expand: int = 2,
                  head_dim: int = 64, conv_width: int = 4) -> dict:
    d_inner = expand * d_model
    heads = d_inner // head_dim
    conv_ch = d_inner + 2 * ssm_state
    return {
        "in_proj": dense_leaf((d_model, 2 * d_inner + 2 * ssm_state + heads)),
        "conv_w": dense_leaf((conv_width, conv_ch), fan_in=conv_width),
        "a_log": Leaf((heads,)),
        "dt_bias": Leaf((heads,), "fill", fill=((heads, -2.0),)),
        "d_skip": Leaf((heads,), "fill", fill=((heads, 1.0),)),
        "norm_scale": Leaf((d_inner,)),
        "out_proj": dense_leaf((d_inner, d_model)),
    }


def _ssd_chunk_scan(xh, dt, a, bmat, cmat, h0, chunk: int):
    """Chunkwise SSD. xh: (B,S,H,P); dt: (B,S,H); a: (H,) negative;
    bmat/cmat: (B,S,N); h0: (B,H,P,N). Returns (y (B,S,H,P), hT)."""
    la = dt * a[None, None, :]                       # (B,S,H) log-decay <= 0
    causal = _causal(chunk, xh.device)
    hprev, ys = h0, []
    for xq, dtq, laq, bq, cq in zip(*(_chunk(t, chunk) for t in (
            xh, dt, la, bmat, cmat))):
        cum = torch.cumsum(laq, dim=1)               # (B,q,H)
        # intra-chunk: y_i += sum_{j<=i} (c_i . b_j) exp(cum_i - cum_j) dt_j x_j
        seg = cum[:, :, None, :] - cum[:, None, :, :]          # (B,qi,qj,H)
        decay = _masked_exp(seg, causal)
        scores = torch.einsum("bin,bjn->bij", cq, bq)          # (B,q,q)
        w = scores[:, :, :, None] * decay * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", w, xq)
        # inter-chunk: y_i += (c_i . h_prev) * exp(cum_i)
        y_inter = torch.einsum("bin,bhpn->bihp", cq, hprev) \
            * torch.exp(cum)[..., None]
        # state: h' = h exp(cum_end) + sum_j exp(cum_end - cum_j) dt_j b_j x_j^T
        tail = torch.exp(cum[:, -1:, :] - cum)                 # (B,q,H)
        hprev = hprev * torch.exp(cum[:, -1])[:, :, None, None] + \
            torch.einsum("bjh,bjn,bjhp->bhpn", tail * dtq, bq, xq)
        ys.append(y_intra + y_inter)
    return _unchunk(torch.stack(ys)), hprev


def mamba2_apply(p: dict, x: torch.Tensor, *, ssm_state: int,
                 chunk: int = 256, state: dict | None = None):
    """x: (B, S, d). Returns (y, new_state) with state = {conv, ssm}."""
    b, s, _ = x.shape
    proj = x @ p["in_proj"]
    d_inner = p["out_proj"].shape[0]
    heads = p["a_log"].shape[0]
    head_dim = d_inner // heads
    z, xbc, dt_raw = torch.split(
        proj, [d_inner, d_inner + 2 * ssm_state, heads], dim=-1)
    conv_state = state["conv"] if state is not None else None
    xbc, conv_state = causal_conv1d(F.silu(xbc), p["conv_w"], conv_state)
    x_in, bmat, cmat = torch.split(xbc, [d_inner, ssm_state, ssm_state],
                                   dim=-1)
    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None, :])  # (B,S,H)
    a = -torch.exp(p["a_log"])                                      # (H,)
    xh = x_in.reshape(b, s, heads, head_dim)

    h0 = (state["ssm"] if state is not None else
          torch.zeros((b, heads, head_dim, ssm_state), dtype=torch.float32,
                      device=x.device))
    if s == 1:
        # decode: a single recurrent step
        la = (dt * a[None, None, :])[:, 0]                          # (B,H)
        h_t = h0 * torch.exp(la)[:, :, None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, 0], bmat[:, 0].float(),
            xh[:, 0].float())
        y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), h_t)[:, None]
    else:
        # pad S to a positive multiple of chunk; padded steps carry dt = 0,
        # so their decay is exp(0) = 1 and they add nothing: the state is
        # carried exactly
        pad = _pad_len(s, chunk)
        y, h_t = _ssd_chunk_scan(
            _pad_seq(xh.float(), pad), _pad_seq(dt, pad), a,
            _pad_seq(bmat.float(), pad), _pad_seq(cmat.float(), pad), h0,
            min(chunk, s + pad))
        y = y[:, :s]
    y = y + xh.float() * p["d_skip"][None, None, :, None]
    y = y.reshape(b, s, d_inner).to(x.dtype) * F.silu(z)
    y = rms_norm(y, p["norm_scale"])
    return y @ p["out_proj"], {"conv": conv_state, "ssm": h_t}


def mamba2_init_state(p: dict, batch: int, ssm_state: int) -> dict:
    heads = p["a_log"].shape[0]
    d_inner = p["out_proj"].shape[0]
    width, conv_ch = p["conv_w"].shape
    dev = p["in_proj"].device
    return {
        "conv": torch.zeros((batch, width - 1, conv_ch),
                            dtype=p["in_proj"].dtype, device=dev),
        "ssm": torch.zeros((batch, heads, d_inner // heads, ssm_state),
                           dtype=torch.float32, device=dev),
    }


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix-memory cell, stabilized exponential gating)
# ---------------------------------------------------------------------------

def mlstm_leaves(d_model: int, num_heads: int) -> dict:
    sq = (d_model, d_model)
    return {
        "wq": dense_leaf(sq), "wk": dense_leaf(sq), "wv": dense_leaf(sq),
        "w_if": dense_leaf((d_model, 2 * num_heads)),
        "w_o": dense_leaf(sq), "out_proj": dense_leaf(sq),
        "if_bias": Leaf((2 * num_heads,), "fill",
                        fill=((num_heads, 0.0), (num_heads, 3.0))),
    }


def _mlstm_chunk_scan(q, k, v, log_i, log_f, state, chunk: int):
    """q,k,v: (B,S,H,P) f32; log_i/log_f: (B,S,H); state: (C (B,H,P,P),
    n (B,H,P), m (B,H)). Chunkwise stabilized mLSTM."""
    p = q.shape[-1]
    scale = p ** -0.5
    causal = _causal(chunk, q.device)
    cmat, nvec, m = state
    ys = []
    for qq, kq, vq, liq, lfq in zip(*(_chunk(t, chunk) for t in (
            q, k, v, log_i, log_f))):
        bq = torch.cumsum(lfq, dim=1)               # (B,q,H) cumulative log f
        # g_i = max_{j<=i} (log_i_j - b_j); stabilizer m_i = b_i + max(m, g_i)
        gi = torch.cummax(liq - bq, dim=1).values
        m_st = m[:, None, :]
        m_new = bq + torch.maximum(m_st, gi)        # (B,q,H)
        # intra-chunk weights exp(b_i - b_j + log_i_j - m_i) for j <= i
        logw = (bq[:, :, None, :] - bq[:, None, :, :]
                + liq[:, None, :, :] - m_new[:, :, None, :])
        w = _masked_exp(logw, causal)               # (B,qi,qj,H)
        scores = torch.einsum("bihp,bjhp->bijh", qq, kq) * scale
        sw = scores * w
        num_intra = torch.einsum("bijh,bjhd->bihd", sw, vq)
        den_intra = sw.sum(dim=2)                   # (B,q,H)
        # inter-chunk decay exp(b_i + m_st - m_i)
        inter = torch.exp(bq + m_st - m_new)        # (B,q,H)
        num_inter = torch.einsum("bihp,bhdp->bihd", qq, cmat) \
            * (inter[..., None] * scale)
        den_inter = torch.einsum("bihp,bhp->bih", qq, nvec) * inter * scale
        num = num_intra + num_inter
        den = den_intra + den_inter
        ys.append(num / torch.maximum(torch.abs(den),
                                      torch.exp(-m_new))[..., None])
        # the state at the chunk's end
        m_end = m_new[:, -1]                        # (B,H)
        tail = torch.exp(bq[:, -1:, :] - bq + liq - m_end[:, None, :])
        carry = torch.exp(bq[:, -1] + m - m_end)    # (B,H)
        cmat = cmat * carry[:, :, None, None] + torch.einsum(
            "bjh,bjhd,bjhp->bhdp", tail, vq, kq)
        nvec = nvec * carry[:, :, None] + torch.einsum(
            "bjh,bjhp->bhp", tail, kq)
        m = m_end
    return _unchunk(torch.stack(ys)), (cmat, nvec, m)


def mlstm_apply(p: dict, x: torch.Tensor, *, num_heads: int,
                chunk: int = 256, state: dict | None = None):
    """x: (B, S, d). Returns (y, state)."""
    b, s, d = x.shape
    hd = d // num_heads
    q = (x @ p["wq"]).reshape(b, s, num_heads, hd).float()
    k = (x @ p["wk"]).reshape(b, s, num_heads, hd).float()
    v = (x @ p["wv"]).reshape(b, s, num_heads, hd).float()
    gates = (x @ p["w_if"]).float() + p["if_bias"]
    log_i, f_raw = torch.chunk(gates, 2, dim=-1)     # (B,S,H) each
    log_f = F.logsigmoid(f_raw)
    o = torch.sigmoid(x @ p["w_o"])

    if state is None:
        state = mlstm_init_state(p, b, num_heads)
    st = (state["c"], state["n"], state["m"])
    if s == 1:
        cmat, nvec, m = st
        li, lf = log_i[:, 0], log_f[:, 0]
        m_new = torch.maximum(lf + m, li)
        fp = torch.exp(lf + m - m_new)
        ip = torch.exp(li - m_new)
        c_new = cmat * fp[:, :, None, None] + torch.einsum(
            "bhd,bhp->bhdp", v[:, 0], k[:, 0]) * ip[:, :, None, None]
        n_new = nvec * fp[:, :, None] + k[:, 0] * ip[:, :, None]
        num = torch.einsum("bhp,bhdp->bhd", q[:, 0], c_new) * (hd ** -0.5)
        den = torch.einsum("bhp,bhp->bh", q[:, 0], n_new) * (hd ** -0.5)
        hout = (num / torch.maximum(torch.abs(den),
                                    torch.exp(-m_new))[..., None])[:, None]
        st_new = (c_new, n_new, m_new)
    else:
        # pad with the i-gate at 0 (log_i = -1e30) and the f-gate at 1
        # (log_f = 0): the padded tail neither adds to nor decays the state
        pad = _pad_len(s, chunk)
        hout, st_new = _mlstm_chunk_scan(
            _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad),
            _pad_seq(log_i, pad, value=NEG_BIG), _pad_seq(log_f, pad), st,
            min(chunk, s + pad))
        hout = hout[:, :s]
    y = hout.reshape(b, s, d).to(x.dtype) * o
    return y @ p["out_proj"], {"c": st_new[0], "n": st_new[1],
                               "m": st_new[2]}


def mlstm_init_state(p: dict, batch: int, num_heads: int) -> dict:
    d = p["wq"].shape[0]
    hd = d // num_heads
    dev = p["wq"].device
    return {
        "c": torch.zeros((batch, num_heads, hd, hd), dtype=torch.float32,
                         device=dev),
        "n": torch.zeros((batch, num_heads, hd), dtype=torch.float32,
                         device=dev),
        "m": torch.full((batch, num_heads), NEG_BIG, dtype=torch.float32,
                        device=dev),
    }


# ---------------------------------------------------------------------------
# sLSTM (scalar cell with block-diagonal recurrence, exponential gating)
# ---------------------------------------------------------------------------

def slstm_leaves(d_model: int, num_heads: int) -> dict:
    hd = d_model // num_heads
    return {
        "w_in": dense_leaf((d_model, 4 * d_model)),
        # recurrent block-diagonal: (H, hd, 4 hd)
        "r": dense_leaf((num_heads, hd, 4 * hd), fan_in=hd),
        "bias": Leaf((4 * d_model,), "fill",
                     fill=((2 * d_model, 0.0), (d_model, 3.0),
                           (d_model, 0.0))),
        "out_proj": dense_leaf((d_model, d_model)),
    }


def slstm_apply(p: dict, x: torch.Tensor, *, num_heads: int,
                state: dict | None = None):
    """x: (B, S, d). A sequential scan over time (inherently recurrent):
    one step per position, a dozen small kernels each. The loop keeps its
    state heads-first, (H, B, hd), so that a step's recurrent product and
    the input's projection are one ``baddbmm``."""
    b, s, d = x.shape
    hd = d // num_heads
    if state is None:
        state = slstm_init_state(p, b, num_heads)
    r = p["r"].float()                                 # (H, hd, 4 hd)
    pre = ((x @ p["w_in"]).float().reshape(b, s, num_heads, 4 * hd)
           + p["bias"].reshape(num_heads, 4 * hd))
    pre = pre.permute(1, 2, 0, 3).contiguous()         # (S, H, B, 4 hd)
    c, n, h, m = (state[k].transpose(0, 1) for k in ("c", "n", "h", "m"))
    # a tensor, as jnp.maximum(n, 1.0): a tie (n = 1 at the first step)
    # splits the gradient in both packages
    one = torch.ones((), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(s):
        z_r, i_r, f_r, o_r = torch.baddbmm(pre[t], h, r).chunk(4, dim=-1)
        lfm = F.logsigmoid(f_r) + m
        m_new = torch.maximum(lfm, i_r)
        fp = torch.exp(lfm - m_new)
        ip = torch.exp(i_r - m_new)
        c = torch.addcmul(fp * c, ip, torch.tanh(z_r))
        n = torch.addcmul(ip, fp, n)
        h = torch.sigmoid(o_r) * c / torch.maximum(n, one)
        m = m_new
        hs.append(h)
    y = torch.stack(hs, dim=2).permute(1, 2, 0, 3).reshape(b, s, d)
    new = {k: t.transpose(0, 1) for k, t in (("c", c), ("n", n), ("h", h),
                                             ("m", m))}
    return y.to(x.dtype) @ p["out_proj"], new


def slstm_init_state(p: dict, batch: int, num_heads: int) -> dict:
    d = p["out_proj"].shape[0]
    hd = d // num_heads
    dev = p["out_proj"].device
    z = lambda: torch.zeros((batch, num_heads, hd), dtype=torch.float32,
                            device=dev)
    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, num_heads, hd), NEG_BIG,
                            dtype=torch.float32, device=dev)}
