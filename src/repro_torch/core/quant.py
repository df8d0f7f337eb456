"""Wire codecs for quantized gossip: int8 / fp8 payloads and error feedback.

A node's gossip payload is quantized once per (round, gossip step) on the
sender: it crosses every link as a narrow-dtype tensor plus one fp32
absmax scale per node row (the "scale sidecar"), and every receiver
dequantizes the same values before the mixing product. A node's own
diagonal term goes through the codec too, as in the reference, so the
function does not depend on how rows are laid out.

Codecs
------
``int8``   symmetric absmax: ``scale = absmax/127`` per row, payload in
           ``[-127, 127]``.
``fp8``    absmax-rescaled cast to ``torch.float8_e4m3fn`` (``fp8_e5m2``
           selects ``torch.float8_e5m2``): ``scale = absmax/F8_MAX``.

Rounding is stochastic when a uniform tensor ``u`` (one draw per element,
in [0, 1)) is given — unbiased, ``E[dequantize(quantize(x, u))] = x`` —
and round-to-nearest (half to even, as ``jnp.round``) otherwise. The
reference keys its uniforms with threefry ``fold_in(seed, round, step,
node)``; the port takes ``u`` as an argument, so the reference's uniforms
can be fed in, and draws its own from a counter hash
(``wire_uniforms``, ``repro_torch.core.streams``): a function of (seed,
round, step, node) alone, bitwise the same on the CPU and on the card.

Error feedback
--------------
``encode(v, wire, u, ef)`` sends ``Q(v + ef)`` and keeps
``ef' = (v + ef) - dequantize(Q(v + ef))``. The residual rides the round
state (``ColaState.ef``), so the quantization error telescopes across
rounds instead of piling up as a noise floor.

Bytes
-----
``wire_itemsize`` (1 for int8/fp8, 4 for fp32) and ``SCALE_BYTES`` (one
fp32 scale per row) give ``payload_bytes``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core import streams

#: wire names accepted by ``ColaConfig.wire``
WIRES = ("fp32", "fp8", "fp8_e5m2", "int8")

#: bytes of the per-row fp32 absmax scale beside every quantized payload
SCALE_BYTES = 4

# name -> (dtype, largest finite value, mantissa bits)
_F8 = {"fp8": (torch.float8_e4m3fn, 448.0, 3),
       "fp8_e5m2": (torch.float8_e5m2, 57344.0, 2)}

# key slot of the codec's uniforms, apart from every other stream drawn
# from the run seed (ASCII "wire", the reference's slot)
_WIRE_STREAM = 0x77697265


def canonical_wire(wire: str | None) -> str:
    w = wire or "fp32"
    if w not in WIRES:
        raise ValueError(f"wire={wire!r}: expected one of {WIRES}")
    return w


def is_quantized(wire: str | None) -> bool:
    return canonical_wire(wire) != "fp32"


def wire_dtype(wire: str) -> torch.dtype:
    w = canonical_wire(wire)
    if w == "fp32":
        return torch.float32
    if w == "int8":
        return torch.int8
    return _F8[w][0]


def wire_itemsize(wire: str | None) -> int:
    """Bytes per payload element on this wire (1 for int8/fp8)."""
    return 4 if canonical_wire(wire) == "fp32" else 1


def wire_qmax(wire: str) -> float:
    w = canonical_wire(wire)
    if w == "int8":
        return 127.0
    if w == "fp32":
        raise ValueError("fp32 wire has no quantization grid")
    return _F8[w][1]


def _sr_int_grid(y, u):
    # stochastic rounding on the integer grid: floor(y + u), u ~ U[0, 1)
    return torch.floor(y + u)


def _sr_f8_grid(y, u, mant_bits: int):
    # stochastic rounding on the local power-of-two fp8 grid: ulp =
    # 2^(e - mant_bits) with e = floor(log2(max(|y|, 2^-24))), floor |y| /
    # ulp + u, scale back. The exponent is taken exactly, from frexp, and
    # ulp is built from its bits: exact on every device. (The reference's
    # log2 may round up to e + 1 within a few fp32 ulps below a power of
    # two; tests/test_torch_quant.py pins that difference.)
    a = torch.abs(y)
    _, ex = torch.frexp(torch.clamp(a, min=2.0 ** -24))
    biased = (ex - 1 - mant_bits + 127).to(torch.int32)
    ulp = torch.bitwise_left_shift(biased, 23).view(torch.float32)
    mag = torch.floor(a / ulp + u) * ulp
    return torch.sign(y) * mag


def quantize(x: torch.Tensor, wire: str, u: torch.Tensor | None = None):
    """Quantize ``x`` by rows (absmax over the LAST axis) onto the wire
    grid.

    Returns ``(payload, scale)``: payload in the wire dtype with ``x``'s
    shape, scale fp32 of shape ``x.shape[:-1] + (1,)``. Stochastic
    rounding when ``u`` (uniforms in [0, 1) of ``x``'s shape) is given,
    round-to-nearest otherwise.
    """
    w = canonical_wire(wire)
    x = x.to(torch.float32)
    if w == "fp32":
        return x, torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                             device=x.device)
    scale = _absmax_scale(torch.amax(torch.abs(x), dim=-1, keepdim=True),
                          w)
    return _to_grid(x, scale, w, u), scale


def _absmax_scale(absmax: torch.Tensor, w: str) -> torch.Tensor:
    # a multiply by the fp32 reciprocal, as the reference spells it: a
    # division by qmax rounds differently
    inv = float(np.float32(1.0 / wire_qmax(w)))
    return torch.where(absmax > 0, absmax * inv, torch.ones_like(absmax))


def _to_grid(x, scale, w: str, u):
    """The payload of fp32 ``x`` under ``scale`` (elementwise)."""
    qmax = wire_qmax(w)
    y = x / scale
    if w == "int8":
        y = _sr_int_grid(y, u) if u is not None else torch.round(y)
        q = torch.clamp(y, -qmax, qmax).to(torch.int8)
    else:
        if u is not None:
            y = _sr_f8_grid(y, u, _F8[w][2])
        q = torch.clamp(y, -qmax, qmax).to(wire_dtype(w))
    return q


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``quantize``: the fp32 values every receiver sees."""
    return q.to(torch.float32) * scale


def saturation_frac(q: torch.Tensor, wire: str) -> torch.Tensor:
    """Fraction of payload elements at the grid's extreme (|q| == qmax):
    a high share means outliers dominate the absmax scale."""
    w = canonical_wire(wire)
    if w == "fp32":
        return torch.zeros((), dtype=torch.float32, device=q.device)
    at_max = torch.abs(q.to(torch.float32)) >= wire_qmax(w)
    return torch.mean(at_max.to(torch.float32))


def quantize_rows(v: torch.Tensor, wire: str, u: torch.Tensor | None = None):
    """Quantize a stack of per-node rows ``v`` (K, d), one scale per row;
    ``u`` is the (K, d) uniforms of the rows (row k = node k's draw)."""
    return quantize(v, wire, u)


def encode(v: torch.Tensor, wire: str, u: torch.Tensor | None = None,
           ef: torch.Tensor | None = None):
    """EF-compensated sender encode: sends ``Q(v + ef)``; the new residual
    is ``(v + ef) - deq`` (None when error feedback is off, ``ef=None``).
    Returns ``(payload, scale, deq, ef_new)``."""
    p = v if ef is None else v + ef
    q, s = quantize_rows(p, wire, u)
    deq = dequantize(q, s)
    ef_new = None if ef is None else p - deq
    return q, s, deq, ef_new


def wire_view(v: torch.Tensor, ef, wire: str, u=None):
    """The dequantized values the network sees for ``v``, and the new EF
    residual: ``(deq, ef_new)``. ``wire='fp32'`` is the identity."""
    if not is_quantized(wire):
        return v, ef
    _, _, deq, ef_new = encode(v, wire, u, ef)
    return deq, ef_new


def ef_init(v_stack: torch.Tensor, wire: str):
    """Zero EF residual shaped like the estimate stack (None on fp32)."""
    if not is_quantized(wire):
        return None
    return torch.zeros_like(v_stack)


# --- pytree wire (gossip-SGD path) -----------------------------------------

# elements per chunk of ``wire_view_leaf_``: bounds the codec's and the
# draws' temporaries at full width
LEAF_CHUNK = 1 << 26


def wire_view_leaf_(leaf: torch.Tensor, wire: str, key: int | None = None,
                    u: torch.Tensor | None = None, keep=None
                    ) -> torch.Tensor:
    """Quantize-dequantize one contiguous (K, ...)-stacked leaf IN PLACE
    as (K, n) rows, one absmax scale per node row, in chunks of
    ``LEAF_CHUNK`` elements (elementwise: the bits of one pass).
    Stochastic rounding with the uniforms ``u`` ((K, n), fed in) or the
    port's draws under ``key`` (row r, column c at counter r * n + c);
    round-to-nearest with neither. ``keep`` (0-d bool): where False the
    leaf keeps its values."""
    w = canonical_wire(wire)
    rows = leaf.view(leaf.shape[0], -1)
    n = rows.shape[1]
    for r in range(rows.shape[0]):
        row = rows[r]
        scale = _absmax_scale(torch.amax(torch.abs(row.float())), w)
        for c0 in range(0, n, LEAF_CHUNK):
            c1 = min(n, c0 + LEAF_CHUNK)
            x = row[c0:c1].float()
            uc = (u.reshape(rows.shape)[r, c0:c1] if u is not None
                  else None if key is None
                  else streams.uniform(key, (c1 - c0,), leaf.device,
                                       offset=r * n + c0))
            deq = dequantize(_to_grid(x, scale, w, uc), scale).to(leaf.dtype)
            row[c0:c1] = deq if keep is None else torch.where(
                keep, deq, row[c0:c1])
    return leaf


def leaf_key(key: int, leaf_index: int) -> int:
    """The SR key of pytree leaf i under a step's key."""
    return streams.fold(key, leaf_index)


def wire_view_pytree(params: dict, wire: str, key: int | None = None,
                     uniforms=None) -> dict:
    """Quantize-dequantize every leaf of a (K, ...)-stacked flat dict (a
    new dict; stateless: no error feedback, the gossip-SGD mixer
    re-quantizes fresh values every mix round). Each leaf is flattened to
    (K, -1) rows with per-node absmax scales. Stochastic rounding takes
    ``uniforms[i]`` for leaf i (fed in, e.g. the reference's) or, with an
    int ``key``, the port's own draws under ``leaf_key(key, i)``, the same
    bits on the CPU and the card; round-to-nearest with neither.
    ``wire='fp32'`` is the identity."""
    if not is_quantized(wire):
        return params
    out = {}
    for i, (name, leaf) in enumerate(params.items()):
        if uniforms is not None:
            kw = {"u": torch.as_tensor(uniforms[i]).to(leaf.device)}
        else:
            kw = {"key": None if key is None else leaf_key(key, i)}
        out[name] = wire_view_leaf_(leaf.contiguous().clone(), wire, **kw)
    return out


def payload_bytes(d: int, wire: str, rows: int = 1) -> int:
    """Wire bytes of one ``rows x d`` payload: the quantized elements and
    the fp32 scale sidecar (one per row; none on fp32)."""
    sidecar = 0 if not is_quantized(wire) else rows * SCALE_BYTES
    return rows * d * wire_itemsize(wire) + sidecar


def wire_uniforms(seed: int, k: int, d: int, device,
                  rows: slice | None = None
                  ) -> Callable[[int, int], torch.Tensor]:
    """The port's own stochastic-rounding draws: ``draws(round, step)`` ->
    (K, d) fp32 uniforms, node k's row at counters k*d .. k*d + d-1 under
    the key fold(seed, round, step). A function of (seed, round, step,
    node) alone, the same on the CPU and the card, no host sync.

    ``rows``: a node range ``start:stop`` of the K rows (a rank's block,
    ``repro_torch.dist``): ``draws`` then gives those (stop - start, d)
    rows only, drawn at their own counters, bitwise the same rows of the
    (K, d) draw."""
    base = streams.fold(_WIRE_STREAM, seed)
    r0, r1 = (0, k) if rows is None else rows.indices(k)[:2]
    return lambda t, step: streams.uniform(streams.fold(base, t, step),
                                           (r1 - r0, d), device,
                                           offset=r0 * d)
