"""Gossip mixing operators on stacked node state: v_k <- sum_l W_kl v_l
(Algorithm 1, step 4).

``mix_power`` applies B gossip steps (App. E.2) on the fp32 wire by
folding W first: B-1 (K, K) products and one (K, d) mix, O(B K^3 + K^2 d)
instead of the sequential O(B K^2 d). ``qmix_steps`` runs the B steps
over a quantized wire (``repro_torch.core.quant``), one encode per step.
``robust_mix_steps`` replaces the linear mix with a Byzantine-resilient
aggregation (``ColaConfig.robust``: a gated trimmed mean, a gated median
or per-neighbor clipping; see ``robust_neighborhood_mix``).
``ring_mix_ppermute`` and ``dense_mix_shardmap`` are one gossip step for
one node per rank of a ``repro_torch.dist.axis.NodeAxis``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import quant


def dense_mix(w: torch.Tensor, v_stack: torch.Tensor) -> torch.Tensor:
    """v'_k = sum_l W_kl v_l for stacked node state.

    Args:
      w: (K, K) mixing matrix.
      v_stack: (K, ...) per-node state stacked on axis 0.
    """
    flat = v_stack.reshape(v_stack.shape[0], -1)
    return (w.to(flat.dtype) @ flat).reshape(v_stack.shape)


def mix_power(w: torch.Tensor, v_stack: torch.Tensor, steps: int) -> torch.Tensor:
    """Apply B consecutive gossip steps, (W^B) v."""
    if steps <= 0:
        return v_stack
    w_pow = w
    for _ in range(steps - 1):
        w_pow = w @ w_pow
    return dense_mix(w_pow, v_stack)


def mix_power_wire(w: torch.Tensor, v_send: torch.Tensor,
                   v_self: torch.Tensor | None, steps: int) -> torch.Tensor:
    """B gossip steps where the FIRST step mixes on-the-wire payloads.

    ``v_send`` is what each node emitted; ``v_self`` is the stacked honest
    state, or None when nothing was corrupted (then exactly ``mix_power``).
    A node's own contribution W_kk v_k uses its honest state, so the first
    step is ``W v_send + diag(W) (v_self - v_send)``."""
    if v_self is None or steps <= 0:
        return mix_power(w, v_send, steps)
    first = dense_mix(w, v_send)
    diag = torch.diagonal(w).to(first.dtype)
    first = first + diag[:, None] * (v_self - v_send)
    return mix_power(w, first, steps - 1)


def qmix_steps(w: torch.Tensor, v_stack: torch.Tensor, ef, steps: int,
               wire: str, draws=None, payload=None, sig: dict | None = None):
    """B gossip steps over a QUANTIZED wire.

    Every step, each node encodes its current value once (EF-compensated
    when ``ef`` is not None; stochastic rounding with the uniforms
    ``draws(step)``, (K, d), or round-to-nearest when ``draws`` is None),
    and the mix runs on the dequantized stack: ``W @ deq``. Every
    contribution goes through the codec, the node's own diagonal term
    included. ``payload``: an optional pre-encoded ``(q, scale)`` for the
    first step (the pipelined driver's double buffer). ``sig``: an
    optional dict that receives the first step's payload as ``sig["q"]``
    (the telemetry counters' saturation signal).

    Returns ``(mixed, ef_new)``.
    """
    out = v_stack
    for s in range(steps):
        if s == 0 and payload is not None:
            q = payload[0]
            deq = quant.dequantize(*payload)
        else:
            u = None if draws is None else draws(s)
            q, _, deq, ef = quant.encode(out, wire, u, ef)
        if s == 0 and sig is not None:
            sig["q"] = q
        out = dense_mix(w, deq)
    return out, ef


# ---------------------------------------------------------------------------
# the node axis over torch.distributed ranks (``repro_torch.dist``)
# ---------------------------------------------------------------------------

def banded_weights(w: torch.Tensor, conn: int) -> torch.Tensor:
    """The (2*conn+1,) band [w_-c .. w_0 .. w_+c] of a circulant W, read
    off its row 0. Assumes the band; ``check_circulant_band`` checks it on
    the host."""
    k = w.shape[0]
    cols = torch.arange(-conn, conn + 1, device=w.device) % k
    return w[0, cols]


def check_circulant_band(w, conn: int, atol: float = 1e-6) -> None:
    """Raise ValueError unless ``w`` (host array) is circulant with
    bandwidth <= ``conn``, so that the banded ring reproduces W exactly.
    The band must not wrap onto itself (2 conn <= K): beyond that two
    offsets reach the same neighbor and the ring would count it twice."""
    w = np.asarray(w)
    k = w.shape[0]
    if 2 * conn > k:
        raise ValueError(f"a band of connectivity {conn} wraps onto itself "
                         f"on {k} nodes (2 conn > K)")
    offs = np.arange(-conn, conn + 1)
    band = w[0, offs % k]
    rows = np.arange(k)
    rebuilt = np.zeros_like(w)
    rebuilt[rows[None, :], (rows[None, :] + offs[:, None]) % k] = \
        band[:, None]
    if not np.allclose(w, rebuilt, atol=atol):
        raise ValueError(
            f"W is not circulant-banded with connectivity {conn}: banded "
            f"ppermute mixing would drop {np.abs(w - rebuilt).max():.3g} of "
            "weight mass — use the dense mixing path for this graph")


def ring_mix_ppermute(v_local: torch.Tensor, axis, weights: torch.Tensor,
                      conn: int = 1) -> torch.Tensor:
    """One banded circulant gossip step for this rank's node, one node per
    rank of ``axis`` (a ``repro_torch.dist.axis.NodeAxis``): for each
    offset, one exchange receiving from i - off and one from i + off, or
    one alone where both reach the same other node (2 off = K, the
    two-node ring: the reference counts that neighbor twice). ``weights``: the
    ``banded_weights`` band."""
    k = axis.size
    out = weights[conn] * v_local
    for off in range(1, conn + 1):
        from_minus = axis.permute(v_local,
                                  [(i, (i + off) % k) for i in range(k)])
        if (2 * off) % k or off % k == 0:
            from_plus = axis.permute(v_local,
                                     [((i + off) % k, i) for i in range(k)])
            out = out + weights[conn + off] * from_plus
        out = out + weights[conn - off] * from_minus
    return out


def dense_mix_shardmap(v_local: torch.Tensor, axis,
                       w: torch.Tensor) -> torch.Tensor:
    """One gossip step of any W for this rank's node (one node per rank):
    all-gather the (K, ...) stack, mix, keep this rank's row. K |v| bytes
    per rank."""
    return dense_mix(w, axis.all_gather(v_local[None]))[axis.index]


# ---------------------------------------------------------------------------
# robust (Byzantine-resilient) aggregation
# ---------------------------------------------------------------------------

ROBUST_MODES = ("trim", "median", "clip")

# adaptive clip radius = factor x median neighbor deviation norm: > 1 so the
# honest spread passes unclipped
_CLIP_TAU_FACTOR = 3.0

# outlier gates of trim/median: a neighbor is distrusted when its payload
# is anti-correlated with the neighborhood's coordinate-median center
# (cosine below _TRIM_COS_GATE: honest estimates of the same dual point
# stay positively correlated once mixing starts, a sign-flipped payload
# reads ~-0.7), or when its norm exceeds _TRIM_NORM_GATE x the (trim+1)-th
# largest neighbor norm (inflation attacks). Honest neighbors trip
# neither, so a clean defended run is the linear mix.
_TRIM_COS_GATE = -0.2
_TRIM_NORM_GATE = 3.0
# the norm gate arms only when the center is nonzero and the payload is not
# positively aligned with it: early-round honest spikes are 3-11x their
# neighbors in norm but correlate positively with a nonzero center
_TRIM_NORM_ARM_COS = 0.2


class _Neighborhood(NamedTuple):
    """The masking and value set-up shared by the robust aggregation and
    its gate (the reference's ``_neighborhood_setup``). Receiver row r's
    slot k holds ``flat[k]``, except its own slot, which holds
    ``self_vals[r]`` (the honest state under a wire attack, ``override``);
    ``mask`` is the support of W (self included)."""

    flat: torch.Tensor       # (K, d) the buffer
    w_rows: torch.Tensor     # (R, K)
    rows: torch.Tensor       # (R,) int64 node ids of the rows
    self_hot: torch.Tensor   # (R, K) bool
    mask: torch.Tensor       # (R, K) bool
    counts: torch.Tensor     # (R,) slots in the support
    self_vals: torch.Tensor  # (R, d)
    override: bool

    @property
    def nb_mask(self) -> torch.Tensor:
        return self.mask & ~self.self_hot

    def slot_norms(self) -> torch.Tensor:
        """(R, K) norms of each slot's value."""
        norm = lambda t: torch.sqrt(torch.sum(t * t, dim=-1))
        flat_n = norm(self.flat)[None, :].expand(self.self_hot.shape)
        if not self.override:
            return flat_n
        return torch.where(self.self_hot, norm(self.self_vals)[:, None],
                           flat_n)

    def rows_matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` for the rows' (R, n) ``a``, computed at the stacked
        (K, n) shape with the other rows zero when R < K: a BLAS picks its
        algorithm by shape (one row takes a matrix-vector product that sums
        in another order), so a rank's block of rows is bitwise those rows
        of the stacked aggregation (``topo.plan.rows_product``)."""
        k = self.flat.shape[0]
        if a.shape[0] == k:
            return a @ b
        full = a.new_zeros((k,) + tuple(a.shape[1:]))
        full[self.rows] = a
        return (full @ b)[self.rows]

    def slot_dots(self, y: torch.Tensor) -> torch.Tensor:
        """(R, K) dot of each slot's value with the row's ``y`` (R, d)."""
        dots = self.rows_matmul(y, self.flat.T)
        if not self.override:
            return dots
        return torch.where(self.self_hot,
                           torch.sum(self.self_vals * y, dim=-1)[:, None],
                           dots)

    def weighted_sum(self, w: torch.Tensor) -> torch.Tensor:
        """(R, d) sum_k w[r, k] * slot value (w zero outside the support):
        a (R, K) x (K, d) product, the own slot apart under an override.

        The product runs on the buffer with its non-finite entries zeroed,
        so a slot outside a row's support never reaches the row (0 * inf
        would make it NaN). Where a row's support holds a non-finite entry
        the output is the product over the raw buffer there: non-finite,
        as the reference's masked sum is (NaN where the reference may give
        an infinity, when another non-finite entry lies outside the
        support). A finite buffer's product is the same call on the same
        values, so its bits do not change."""
        support = self.nb_mask if self.override else self.mask
        if self.override:
            w_self = torch.sum(torch.where(self.self_hot, w, 0.0), dim=1)
            w = torch.where(self.self_hot, 0.0, w)
        bad = ~torch.isfinite(self.flat)
        out = self.rows_matmul(w, self.flat.masked_fill(bad, 0.0))
        hit = self.rows_matmul(support.to(out.dtype), bad.to(out.dtype)) > 0
        out = torch.where(hit, self.rows_matmul(w, self.flat), out)
        if not self.override:
            return out
        return out + w_self[:, None] * self.self_vals


def _neighborhood(w_rows, buf, row_ids, self_override) -> _Neighborhood:
    k = buf.shape[0]
    flat = buf.reshape(k, -1)
    w_rows = torch.as_tensor(w_rows, device=flat.device).to(flat.dtype)
    rows = torch.as_tensor(row_ids, device=flat.device).to(torch.int64)
    r = rows.shape[0]
    self_hot = torch.arange(k, device=flat.device)[None, :] == rows[:, None]
    mask = (w_rows != 0) | self_hot
    counts = torch.sum(mask.to(torch.int64), dim=1)
    self_vals = (flat[rows] if self_override is None
                 else self_override.reshape(r, -1).to(flat.dtype))
    return _Neighborhood(flat, w_rows, rows, self_hot, mask, counts,
                         self_vals, self_override is not None)


def _masked_trimmed_mean(vals, mask, b_counts, counts):
    """Coordinate-wise trimmed mean over the masked slots of ``vals`` (R, K,
    d): drops ``b_counts`` (R,) extremes from each side of the ``counts``
    (R,) masked slots. Masked-out slots hold the dtype's max, so every
    sort places them past the kept window."""
    big = torch.finfo(vals.dtype).max
    guarded = torch.where(mask[:, :, None], vals, big)
    srt = torch.sort(guarded, dim=1).values
    idx = torch.arange(vals.shape[1], device=vals.device)[None, :, None]
    keep = (idx >= b_counts[:, None, None]) \
        & (idx < (counts - b_counts)[:, None, None])
    kept = torch.sum(torch.where(keep, srt, 0.0), dim=1)
    denom = torch.clamp(counts - 2 * b_counts, min=1).to(vals.dtype)
    return kept / denom[:, None]


def _center(nb: _Neighborhood) -> torch.Tensor:
    """(R, d) coordinate-wise neighborhood (lower) median: the
    (counts-1)//2-th order statistic of the support's values, laid out
    (R, d, K) so that each coordinate's K slots are contiguous; the slots
    outside the support hold the dtype's max, which sorts past them.

    The selected value is bitwise the reference's rank selection for
    every payload that is not NaN or +inf (the reference's sentinels
    order differently there). Values that compare equal are bitwise equal
    except +0.0 and -0.0, and the reference sums the selection with
    zeros, which maps -0.0 to +0.0; adding 0.0 here does the same. So the
    order the sort gives equal values does not matter, and the sort may
    be unstable: at K <= 32 that is PyTorch's bitonic sort, where a
    stable sort takes a radix sort per coordinate, slower on the card
    (``chip_smoke.py``'s ``gate_step`` times both)."""
    big = torch.finfo(nb.flat.dtype).max
    r, d = nb.rows.shape[0], nb.flat.shape[1]
    guarded = torch.where(nb.mask[:, None, :], nb.flat.T.contiguous()[None],
                          big)                                # (R, d, K)
    if nb.override:
        # the own slot is always in the support
        guarded[torch.arange(r, device=guarded.device), :, nb.rows] = \
            nb.self_vals
    srt = torch.sort(guarded, dim=-1).values
    del guarded
    target = (nb.counts - 1) // 2
    return srt.gather(-1, target[:, None, None].expand(r, d, 1))[..., 0] \
        + 0.0


def _gate_center_flags(nb: _Neighborhood, trim: int):
    """Robust center (R, d) and the per-neighbor outlier gate (R, K) of
    trim/median (True: receiver row r rejects sender k's edge this step;
    own slots never flag)."""
    k = nb.flat.shape[0]
    center = _center(nb)
    # the gate on whole-vector geometry: anti-correlation with the robust
    # center, or norm inflation against the (trim+1)-th largest neighbor
    # norm, a reference `trim` colluding liars cannot raise
    norms = nb.slot_norms()                                  # (R, K)
    cnorm = torch.sqrt(torch.sum(center * center, dim=-1))   # (R,)
    cos = nb.slot_dots(center) / (norms * cnorm[:, None] + 1e-30)
    nb_mask = nb.nb_mask
    m_nb = torch.sum(nb_mask.to(torch.int64), dim=1)
    nb_norms = torch.where(nb_mask, norms, -torch.inf)
    depth = torch.clamp(torch.clamp(m_nb - 1, min=0), max=trim)
    # the (k-1-depth)-th order statistic by rank selection, as the
    # reference: one (K, K) comparison per row
    ar = torch.arange(k, device=norms.device)
    n_lt = nb_norms[:, :, None] < nb_norms[:, None, :]
    n_eq = nb_norms[:, :, None] == nb_norms[:, None, :]
    n_ilt = (ar[:, None] < ar[None, :])[None]
    n_rank = torch.sum((n_lt | (n_eq & n_ilt)).to(torch.int64), dim=1)
    n_sel = n_rank == (k - 1 - depth)[:, None]
    ref = torch.sum(torch.where(n_sel, nb_norms, 0.0), dim=1, keepdim=True)
    ref = torch.where(torch.isfinite(ref), ref, 0.0)         # (R, 1)
    # the norm gate needs a positive reference and a payload not aligned
    # with a nonzero center: either false drop would drift the cohort's
    # Lemma-1 invariant
    norm_armed = (ref > 0) & (cnorm[:, None] > 0) \
        & (cos < _TRIM_NORM_ARM_COS)
    flagged = (cos < _TRIM_COS_GATE) | \
              ((norms > _TRIM_NORM_GATE * ref) & norm_armed)
    return center, flagged & nb_mask


def _clip_scale(nb: _Neighborhood, clip):
    """Per-neighbor deviation clipping of mode="clip": the (R, K, d)
    deviations from the own value and the (R, K) clip factors (``< 1``
    exactly where a deviation was clipped)."""
    r = nb.rows.shape[0]
    dev = nb.flat[None] - nb.self_vals[:, None, :]               # (R, K, d)
    if nb.override:
        # a device zero: a Python scalar here would be copied from the
        # host, which waits for the stream
        dev[torch.arange(r, device=dev.device), nb.rows] = dev.new_zeros(())
    norms = torch.sqrt(torch.sum(dev * dev, dim=-1))             # (R, K)
    nb_mask = nb.nb_mask
    if clip is not None:
        tau = torch.full((r,), clip, dtype=dev.dtype, device=dev.device)
    else:
        # a multiple of the median neighbor deviation norm: typical
        # honest neighbors stay unclipped, a sign flip's ~2||v|| does not
        m_nb = torch.sum(nb_mask.to(torch.int64), dim=1)
        m1 = torch.clamp(m_nb, min=1)
        tau = _masked_trimmed_mean(norms[:, :, None], nb_mask,
                                   (m1 - 1) // 2, m1)[:, 0]
        tau = torch.where(m_nb > 0, _CLIP_TAU_FACTOR * tau, 0.0)
    scale = torch.clamp(tau[:, None] / (norms + 1e-30), max=1.0)
    return dev, scale


def _check_mode(mode: str) -> None:
    if mode not in ROBUST_MODES:
        raise ValueError(f"unknown robust mode {mode!r} "
                         f"(want one of {ROBUST_MODES})")


def gate_flags(w_rows, buf: torch.Tensor, row_ids, mode: str, *,
               trim: int = 1, clip: float | None = None,
               self_override: torch.Tensor | None = None) -> torch.Tensor:
    """The (R, K) per-edge rejection mask the robust aggregation applies:
    True where receiver row r rejects sender k's edge this step (trim /
    median: the outlier gate fired; clip: the deviation was clipped). Own
    slots never flag. Same arguments as ``robust_neighborhood_mix``."""
    _check_mode(mode)
    nb = _neighborhood(w_rows, buf, row_ids, self_override)
    if mode in ("trim", "median"):
        return _gate_center_flags(nb, trim)[1]
    _, scale = _clip_scale(nb, clip)
    return (scale < 1.0) & nb.nb_mask


def robust_center(w_rows, buf: torch.Tensor, row_ids, *,
                  self_override: torch.Tensor | None = None) -> torch.Tensor:
    """(R, d) the coordinate-wise neighborhood median the trim/median gate
    tests against (the reference computes it inside the gate)."""
    return _center(_neighborhood(w_rows, buf, row_ids, self_override))


def robust_neighborhood_mix(w_rows, buf: torch.Tensor, row_ids, mode: str, *,
                            trim: int = 1, clip: float | None = None,
                            self_override: torch.Tensor | None = None,
                            sig: dict | None = None) -> torch.Tensor:
    """Robust aggregation of a neighborhood buffer, the Byzantine-resilient
    replacement for ``w_rows @ buf``.

    Args:
      w_rows: (R, K) these nodes' rows of the round's W; the support (w !=
        0, self always included) is each neighborhood. A frozen node's row
        e_k returns its own value.
      buf: (K, ...) the values each node emitted.
      row_ids: (R,) node ids of the rows (``arange(K)`` on stacked state).
      mode: "trim"   — each neighbor is tested against the outlier gate
                       (payload anti-correlated with the neighborhood's
                       coordinate-median center, or norm above
                       ``_TRIM_NORM_GATE`` x the (trim+1)-th largest
                       neighbor norm); a flagged neighbor's edge is dropped
                       for this step and its weight moved onto the self
                       term; the rest pass untouched;
            "median" — the same gate, a flagged payload replaced by the
                       center instead of dropped;
            "clip"   — each neighbor's deviation from the own value is
                       clipped to ``clip`` (None: ``_CLIP_TAU_FACTOR`` x the
                       median neighbor deviation norm), then the W-weighted
                       sum runs on the clipped values.
      trim: collusion depth the norm gate survives.
      self_override: optional (R, ...) HONEST own values: under a wire
        attack ``buf`` holds the emitted payloads, but a node's own slot is
        its own state (exempt from the gate).
      sig: optional dict that receives the (R, K) rejection mask this mix
        applied as ``sig["gate"]`` (``gate_flags``' mask; the telemetry
        counters read it from here, so no second gate runs). The output is
        the same with or without it.

    Every output depends only on the slots inside each row's support. The
    gate decides per neighbor from whole-vector geometry, so honest
    payloads pass and a clean defended run takes the linear path: without
    an override, trim and median then return exactly ``w_rows @ buf``
    (the rejected weight, zero, is added to the self term). The (K, K)
    comparisons are the reference's; the center sorts the (R, d, K)
    support values (``_center``), the weighted sums are (R, K) x (K, d)
    products.
    """
    _check_mode(mode)
    nb = _neighborhood(w_rows, buf, row_ids, self_override)
    r = nb.rows.shape[0]
    if mode in ("trim", "median"):
        center, flagged = _gate_center_flags(nb, trim)
        if sig is not None:
            sig["gate"] = flagged
        w_drop = torch.sum(torch.where(flagged, nb.w_rows, 0.0), dim=1)
        out = nb.weighted_sum(torch.where(flagged, 0.0, nb.w_rows))
        # trim: the flagged edges' weight goes onto the own value; median:
        # a flagged payload is replaced by the center
        out = out + w_drop[:, None] * (center if mode == "median"
                                       else nb.self_vals)
        return out.reshape((r,) + buf.shape[1:])
    dev, scale = _clip_scale(nb, clip)
    if sig is not None:
        sig["gate"] = (scale < 1.0) & nb.nb_mask
    clipped = nb.self_vals[:, None, :] + dev * scale[:, :, None]
    del dev
    clipped = torch.where(nb.mask[:, :, None], clipped, 0.0)
    out = torch.einsum("rk,rkd->rd", nb.w_rows, clipped)
    return out.reshape((r,) + buf.shape[1:])


def robust_mix_dense(w: torch.Tensor, v_stack: torch.Tensor, mode: str, *,
                     trim: int = 1, clip: float | None = None,
                     self_stack: torch.Tensor | None = None,
                     sig: dict | None = None) -> torch.Tensor:
    """ONE robust gossip step on stacked (K, ...) node state, the robust
    counterpart of ``dense_mix``; ``self_stack`` holds the honest states
    when ``v_stack`` holds attacked wire payloads; ``sig`` as
    ``robust_neighborhood_mix``'s (the (K, K) mask)."""
    k = v_stack.shape[0]
    flat = v_stack.reshape(k, -1)
    ov = None if self_stack is None else self_stack.reshape(k, -1)
    out = robust_neighborhood_mix(
        w, flat, torch.arange(k, device=flat.device), mode, trim=trim,
        clip=clip, self_override=ov, sig=sig)
    return out.reshape(v_stack.shape).to(v_stack.dtype)


def robust_mix_steps(w: torch.Tensor, v_stack: torch.Tensor, mode: str, *,
                     trim: int = 1, clip: float | None = None,
                     steps: int = 1,
                     self_stack: torch.Tensor | None = None,
                     sig: dict | None = None) -> torch.Tensor:
    """B consecutive robust gossip steps, applied one after the other (the
    aggregation is nonlinear: no W^B fold). A wire attack (``self_stack``
    not None) exists on the FIRST step only; later steps mix received
    values, which are honest. ``sig`` receives the FIRST step's (K, K)
    rejection mask (``robust_neighborhood_mix``)."""
    out = v_stack
    for i in range(steps):
        out = robust_mix_dense(w, out, mode, trim=trim, clip=clip,
                               self_stack=self_stack if i == 0 else None,
                               sig=sig if i == 0 else None)
    return out
