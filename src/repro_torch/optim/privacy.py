"""Differential privacy for the gossip parameter exchange (counterpart of
``repro.optim.privacy``).

Every gossip mix round each node EMITS its clipped parameter vector onto
the wire; an eavesdropper on the links sees one Gaussian-noised copy per
release.

* The mechanism: per-node L2 clipping to ``clip`` plus Gaussian wire noise
  of std ``sigma * 2 * clip`` (the L2 sensitivity of a clipped emission
  under replace-one-node adjacency is ``2 * clip``). Noise is on the WIRE
  only, the off-diagonal W terms: a node's own ``w_kk`` term stays
  noiseless.
* The accounting: zero-concentrated DP [Bun & Steinke 2016]. A release at
  noise multiplier ``sigma`` costs ``rho = 1 / (2 sigma^2)``; rho adds up,
  and ``epsilon = rho + 2 sqrt(rho ln(1/delta))``. Per-link noise
  (``per_link=True``) hands each of up to ``deg_max`` neighbours an
  independent copy: ``B * deg_max`` releases per node per mix round of B
  gossip steps; broadcast noise ``B``.

The draws. The reference keys its normals with threefry ``fold_in``
chains, which PyTorch cannot reproduce; the port draws its own: Box-Muller
over the counter-hash uniforms of ``core/streams.py`` under the key
fold(seed, round, step, leaf, link), so a draw is a function of those
alone and its uniforms are the same bits on the CPU and the card.
``draws=`` takes the reference's normals instead (parity tests), and
``wire_draws=`` its stochastic-rounding uniforms.

At full width the mix never builds the reference's (K, K) + leaf draw
tensor: the per-link noise of a receiver is summed one link at a time
into one leaf-row accumulator, over the links of the graph only (a zero
weight adds exactly nothing). The in-place form ``noisy_dense_mix_``
writes the mixed values into the parameter stack.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import quant, streams

# key slot of the DP noise, apart from every other stream of the seed
# (ASCII "dpno")
_DP_STREAM = 0x64706E6F


@dataclasses.dataclass(frozen=True)
class DPConfig:
    """Gaussian-mechanism parameters for the gossip wire.

    ``clip``     per-node L2 bound on the emitted parameter vector (all
                 leaves, flattened), enforced before every emission;
    ``sigma``    noise multiplier: wire noise std is ``sigma * 2 * clip``;
    ``delta``    target delta of the (epsilon, delta) conversion;
    ``per_link`` an independent draw per directed link (True) or one draw
                 per sender shared by its neighbours (False);
    ``seed``     root of the draws' keys (folded with the round, the gossip
                 step, the leaf and the link).
    """

    clip: float
    sigma: float
    delta: float = 1e-5
    per_link: bool = True
    seed: int = 0

    def __post_init__(self):
        if self.clip <= 0 or self.sigma <= 0:
            raise ValueError("DPConfig needs clip > 0 and sigma > 0")
        if not (0 < self.delta < 1):
            raise ValueError(f"delta must be in (0, 1), got {self.delta}")

    @property
    def sensitivity(self) -> float:
        return 2.0 * self.clip

    @property
    def noise_std(self) -> float:
        return self.sigma * self.sensitivity

    def releases_per_mix_round(self, graph, gossip_steps: int) -> int:
        """Gaussian releases per node per gossip-mix round."""
        return gossip_steps * (max_degree(graph) if self.per_link else 1)

    def round_key(self, round_: int) -> int:
        """The 32-bit key of a round's draws."""
        return streams.fold(_DP_STREAM, self.seed, round_)


def max_degree(graph) -> int:
    """Largest neighbour count (excluding self) in the topology."""
    adj = np.asarray(graph.adjacency, dtype=bool).copy()
    np.fill_diagonal(adj, False)
    return int(adj.sum(axis=1).max())


class GaussianAccountant:
    """Additive zCDP composition for repeated Gaussian releases: ``add(n)``
    registers n releases at ``sigma``; ``epsilon()`` converts the
    accumulated rho at ``delta``."""

    def __init__(self, sigma: float, delta: float = 1e-5):
        if sigma <= 0:
            raise ValueError("sigma must be > 0")
        self.sigma = float(sigma)
        self.delta = float(delta)
        self.releases = 0

    def add(self, n: int = 1) -> "GaussianAccountant":
        if n < 0:
            raise ValueError("cannot un-release")
        self.releases += int(n)
        return self

    @property
    def rho(self) -> float:
        return self.releases / (2.0 * self.sigma ** 2)

    def epsilon(self, delta: float | None = None) -> float:
        delta = self.delta if delta is None else delta
        rho = self.rho
        if rho == 0.0:
            return 0.0
        return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


def epsilon_schedule(dp: DPConfig, graph, gossip_steps: int,
                     mixes_so_far) -> np.ndarray:
    """Cumulative epsilon after each entry of ``mixes_so_far`` (a running
    count of completed gossip-mix rounds), on the host."""
    per_round = dp.releases_per_mix_round(graph, gossip_steps)
    out = np.empty(len(mixes_so_far), dtype=np.float64)
    for i, m in enumerate(np.asarray(mixes_so_far, dtype=np.int64)):
        acct = GaussianAccountant(dp.sigma, dp.delta).add(int(m) * per_round)
        out[i] = acct.epsilon()
    return out


# ---------------------------------------------------------------------------
# the mechanism: clip + wire noise over (K, ...)-stacked flat dicts
# ---------------------------------------------------------------------------

def _bcast(v: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return v.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)


def _put(p: torch.Tensor, new: torch.Tensor, keep) -> None:
    """p <- new, or p unchanged where the 0-d bool ``keep`` is False."""
    p.copy_(new if keep is None else torch.where(keep, new, p))


def node_clip_scale(params_stack: dict, clip: float) -> torch.Tensor:
    """(K,) factor min(1, clip / ||p_k||) over each node's whole vector."""
    def sq_norms(p):
        rows = p.float().reshape(p.shape[0], -1)
        return torch.einsum("kn,kn->k", rows, rows)   # no (K, n) square
    sq = sum(sq_norms(p) for p in params_stack.values())
    return torch.clamp(clip / torch.sqrt(sq + 1e-30), max=1.0)


def clip_params(params_stack: dict, clip: float) -> dict:
    """Scale each node's FULL parameter vector (all leaves, flattened) to
    L2 norm <= clip: one factor per node, as in DP-SGD clipping."""
    scale = node_clip_scale(params_stack, clip)
    return {n: p * _bcast(scale, p) for n, p in params_stack.items()}


def _clip_(params_stack: dict, clip: float, keep) -> None:
    scale = node_clip_scale(params_stack, clip)
    for p in params_stack.values():
        if keep is None:
            p.mul_(_bcast(scale, p))
        else:
            _put(p, p * _bcast(scale, p), keep)


def graph_links(w_host: np.ndarray) -> list:
    """(receiver k, sender l) pairs of the off-diagonal support."""
    k = w_host.shape[0]
    return [(i, j) for i in range(k) for j in range(k)
            if i != j and w_host[i, j] != 0]


def noisy_dense_mix_(w: torch.Tensor, params_stack: dict, dp: DPConfig,
                     key: int, steps: int = 1, wire_codec: str | None = None,
                     *, links=None, draws=None, wire_draws=None,
                     keep=None) -> dict:
    """B gossip steps of the dense (K, K) mix with the DP wire mechanism,
    IN PLACE (every leaf of ``params_stack`` ends holding its mixed
    value). Each step runs

        clip -> [quantize-dequantize -> re-clip] -> W p + wire noise

    (the bracket on a quantized ``wire_codec``: clip then quantize, the
    order the sensitivity proof needs; the second clip undoes any norm the
    codec's rounding added). The noise of receiver k is std * sum over
    its links l of W_kl xi_kl (per link) or W_kl xi_l (broadcast).

    Args:
      key: the round's key (``dp.round_key(round)``); leaf i of step s
        draws under fold(key, s, i, k, l) per link (k, l), fold(key, s, i,
        l) per sender; the codec's SR uniforms under
        ``quant.leaf_key(fold(key, s, WIRE), i)``.
      links: (receiver, sender) pairs that may carry noise (default: the
        off-diagonal support of ``w``, read back to the host); pairs with
        a zero weight add nothing.
      draws: optional ``draws(step, leaf) -> tensor``, the normals of
        (K, K) + leaf (per link) or (K,) + leaf (broadcast), e.g. the
        reference's.
      wire_draws: optional ``wire_draws(step, leaf) -> (K, n)`` SR
        uniforms.
      keep: optional 0-d bool; where False every leaf keeps its value.
    """
    k = w.shape[0]
    wire = w * (1.0 - torch.eye(k, dtype=w.dtype, device=w.device))
    if links is None:
        links = graph_links(w.detach().cpu().numpy())
    std = dp.noise_std
    quantized = quant.is_quantized(wire_codec)
    for s in range(steps):
        _clip_(params_stack, dp.clip, keep)
        if quantized:
            wkey = streams.fold(key, s, quant._WIRE_STREAM)
            for i, p in enumerate(params_stack.values()):
                fed = None if wire_draws is None else wire_draws(s, i)
                quant.wire_view_leaf_(
                    p, wire_codec,
                    None if fed is not None else quant.leaf_key(wkey, i),
                    fed, keep)
            _clip_(params_stack, dp.clip, keep)
        for i, p in enumerate(params_stack.values()):
            flat = p.reshape(k, -1)
            wp = wire.to(p.dtype)
            out = w.to(p.dtype) @ flat
            if dp.per_link:
                for r in range(k):
                    senders = [l for (kk, l) in links if kk == r]
                    if not senders:
                        continue
                    acc = torch.zeros_like(flat[0])
                    for l in senders:
                        xi = (draws(s, i)[r, l].reshape(-1)
                              if draws is not None else
                              streams.normal(streams.fold(key, s, i, r, l),
                                             acc.numel(), p.device
                                             ).to(p.dtype))
                        acc += wp[r, l] * xi
                    out[r] += acc * std
            else:
                xi = (draws(s, i).reshape(k, -1) if draws is not None else
                      torch.stack([streams.normal(
                          streams.fold(key, s, i, l), flat.shape[1],
                          p.device) for l in range(k)]).to(p.dtype))
                out += (wp @ xi) * std
            _put(p, out.reshape(p.shape).to(p.dtype), keep)
    return params_stack


def noisy_dense_mix(w: torch.Tensor, params_stack: dict, dp: DPConfig,
                    key: int, steps: int = 1, wire_codec: str | None = None,
                    **kw) -> dict:
    """``noisy_dense_mix_`` on a copy: returns a new dict."""
    return noisy_dense_mix_(w, {n: p.clone() for n, p in
                                params_stack.items()}, dp, key, steps,
                            wire_codec, **kw)
