"""Attack scenarios as transforms of the materialized (T, ...) schedules.

Each scenario is a frozen dataclass whose ``apply(sched, ctx)`` rewrites
the driver's host schedule dict in place (numpy, as both packages build it,
so the port's stacked entries are bitwise the reference's):

* ``Byzantine``     — nodes emit sign-flipped / scaled / random ``v_k``
                      payloads on a round window: ``atk_coef`` (T, K) and,
                      for random payloads, ``atk_bias_coef`` (T, K) and
                      ``atk_bias`` (T, K, d), a broadcast view of run-constant
                      per-node directions. The round body applies
                      ``coef * v + bias_coef * bias`` to the OUTGOING ``v``
                      only: receivers consume the lie, the liar's own mixing
                      term and state stay honest (a two-faced attacker).
* ``FreeRider``     — nodes do no local work (``atk_work`` (T, K) zeroes
                      their dx); ``stale=True`` also makes them emit their
                      initial (zero) state.
* ``LinkCorruption``— scales the payload on chosen directed edges (src ->
                      dst) by rewriting the W stack: ``W[t, dst, src] *=
                      scale``.
* ``Eavesdropper``  — a passive tap: the driver records the tapped nodes'
                      emitted payloads each round into ``RunResult.taps``
                      (T, n_tap, d) for ``repro_torch.attack.audit``.

``scenario(name, ...)`` constructs a registered scenario by name.
``apply_attacks`` runs a list left to right (later scenarios overwrite
overlapping windows of the same entry) and returns the schedule and an
``AttackInfo`` (the entries present, the tap nodes, whether W changed).

``Byzantine`` and ``FreeRider`` are generative: their round-t row is a
function of ``t`` alone, so ``stream_entries(ctx)`` gives a torch
generator on ``ctx.device`` and ``streamed_attacks`` composes a list into
one ``part(t) -> {"atk_*": tensor}`` for the executor's ``stream=`` hook:
the values ``apply_attacks`` would have stacked, bitwise, with no (T, K)
array. ``LinkCorruption`` and ``Eavesdropper`` have no generative form.

The node sets and random directions come from ``numpy.random.default_rng``,
as in the reference: the same seeds give the same bits in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve

# payload-transform schedule entries the round body may read, prefixed
# "atk_" in the schedule dict. "dishonest" is derived: the (T, K) ground
# truth of which nodes' wire payload differs from their state that round,
# which the certificate recorder reads (``metrics.attackify``) to audit the
# honest cohort; the defense never sees it.
ATTACK_ENTRY_NAMES = ("coef", "bias_coef", "bias", "work", "dishonest")

SCENARIOS: dict = {}


def register_scenario(name: str):
    """Class decorator: make the scenario constructible by name."""
    def deco(cls):
        SCENARIOS[name] = cls
        return cls
    return deco


def scenario(name: str, **kwargs):
    """Construct a registered scenario by name:
    ``scenario("byzantine", nodes=(3, 11))``."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown attack scenario {name!r} "
                         f"(registered: {sorted(SCENARIOS)})")
    return SCENARIOS[name](**kwargs)


@dataclasses.dataclass(frozen=True)
class AttackContext:
    """Run facts a scenario may need to materialize its entries.
    ``dtype`` is the numpy dtype of the schedule; ``device`` is where the
    streamed generators put their tensors (default "cuda")."""

    graph: Any          # repro_torch.core.topology.Topology
    rounds: int
    k: int
    d: int
    dtype: Any
    seed: int = 0
    device: Any = None


@dataclasses.dataclass
class AttackInfo:
    """What ``apply_attacks`` did, for the drivers."""

    token: tuple              # hashable summary of the scenario list
    entry_names: tuple        # subset of ATTACK_ENTRY_NAMES present in sched
    tap_nodes: tuple          # eavesdropper node ids
    w_modified: bool          # LinkCorruption rewrote the W stack


def _window(start: int, stop: int | None, rounds: int) -> slice:
    stop = rounds if stop is None else min(stop, rounds)
    if not (0 <= start <= stop):
        raise ValueError(f"bad attack round window [{start}, {stop})")
    return slice(start, stop)


def _ensure_entry(sched: dict, name: str, ctx: AttackContext,
                  fill: float) -> np.ndarray:
    """A writable (T, K) attack entry, created filled with ``fill``."""
    key = "atk_" + name
    if key not in sched:
        sched[key] = np.full((ctx.rounds, ctx.k), fill, dtype=ctx.dtype)
    return sched[key]


def _resolve_nodes(nodes, fraction, ctx: AttackContext, seed: int) -> tuple:
    if nodes is not None:
        nodes = tuple(int(n) for n in nodes)
    elif fraction is not None:
        count = max(1, int(round(fraction * ctx.k)))
        rng = np.random.default_rng(seed)
        nodes = tuple(int(n) for n in
                      sorted(rng.choice(ctx.k, size=count, replace=False)))
    else:
        raise ValueError("need nodes= or fraction=")
    if any(n < 0 or n >= ctx.k for n in nodes):
        raise ValueError(f"attack nodes {nodes} out of range for K={ctx.k}")
    return nodes


def _random_directions(nodes, ctx: AttackContext, seed: int) -> np.ndarray:
    """(K, d) run-constant payload directions: standard normal rows for
    ``nodes`` (one ``default_rng(seed)`` draw), zeros elsewhere."""
    base = np.zeros((ctx.k, ctx.d), dtype=ctx.dtype)
    rng = np.random.default_rng(seed)
    base[list(nodes)] = rng.standard_normal(
        (len(nodes), ctx.d)).astype(ctx.dtype)
    return base


class _Generator:
    """Shared plumbing of the streamed scenarios: the node mask and the
    round window on the context's device."""

    def __init__(self, nodes, rows: slice, ctx: AttackContext):
        self.device = resolve(ctx.device)
        self.dtype = torch.from_numpy(np.zeros((0,), ctx.dtype)).dtype
        hit = np.zeros((ctx.k,), dtype=bool)
        hit[list(nodes)] = True
        self.nodes = torch.as_tensor(hit, device=self.device)
        self.none = torch.zeros_like(self.nodes)
        self.lo, self.hi, self.k = rows.start, rows.stop, ctx.k

    def hit(self, t: int) -> torch.Tensor:
        # the window test on the host: the round index is a Python int
        return self.nodes if self.lo <= t < self.hi else self.none

    def entry(self, entries: dict, name: str, fill: float) -> torch.Tensor:
        return entries.get(name, torch.full((self.k,), fill,
                                            dtype=self.dtype,
                                            device=self.device))


@register_scenario("byzantine")
@dataclasses.dataclass(frozen=True)
class Byzantine:
    """Nodes emit corrupted v_k payloads: ``v_send = coef * v + bias``.

    mode="sign_flip": coef = -scale; mode="scale": coef = scale;
    mode="random": coef = 0, bias = scale * a run-constant standard-normal
    direction per node (drawn from ``seed``). The lie is wire-only: the
    liar's own mixing term and local solve use its honest state.
    """

    nodes: tuple | None = None
    fraction: float | None = None
    mode: str = "sign_flip"
    scale: float = 1.0
    start: int = 0
    stop: int | None = None
    seed: int = 0

    def _check_mode(self) -> None:
        if self.mode not in ("sign_flip", "scale", "random"):
            raise ValueError(f"unknown Byzantine mode {self.mode!r}")

    def apply(self, sched: dict, ctx: AttackContext) -> None:
        self._check_mode()
        nodes = list(_resolve_nodes(self.nodes, self.fraction, ctx,
                                    self.seed))
        rows = _window(self.start, self.stop, ctx.rounds)
        coef = _ensure_entry(sched, "coef", ctx, 1.0)
        if self.mode == "sign_flip":
            coef[rows, nodes] = -self.scale
        elif self.mode == "scale":
            coef[rows, nodes] = self.scale
        else:  # random payload: drop the state, emit a fixed random vector
            coef[rows, nodes] = 0.0
            bias_coef = _ensure_entry(sched, "bias_coef", ctx, 0.0)
            bias_coef[rows, nodes] = self.scale
            if "atk_bias" in sched:
                base = np.array(sched["atk_bias"][0])
            else:
                base = np.zeros((ctx.k, ctx.d), dtype=ctx.dtype)
            base[nodes] = _random_directions(nodes, ctx, self.seed)[nodes]
            # a (T, K, d) broadcast view: O(K d) on the host
            sched["atk_bias"] = np.broadcast_to(base,
                                                (ctx.rounds,) + base.shape)

    def stream_entry_names(self) -> tuple:
        return ("coef", "bias_coef", "bias") if self.mode == "random" \
            else ("coef",)

    def stream_entries(self, ctx: AttackContext):
        """Generative twin of ``apply``: ``gen(t, entries) -> entries``,
        this round's rows from ``t`` alone, chaining left to right as the
        stacked entries overwrite. The random directions are a (K, d)
        tensor on the device, made once; the merged ``atk_bias`` is
        window-independent, so it is made once per distinct input."""
        self._check_mode()
        nodes = _resolve_nodes(self.nodes, self.fraction, ctx, self.seed)
        g = _Generator(nodes, _window(self.start, self.stop, ctx.rounds), ctx)
        scale = self.scale
        if self.mode == "random":
            base = torch.as_tensor(_random_directions(nodes, ctx, self.seed),
                                   device=g.device)
            memo: dict = {}

        def gen(t, entries):
            hit = g.hit(t)
            coef = g.entry(entries, "atk_coef", 1.0)
            if self.mode == "sign_flip":
                coef = torch.where(hit, -scale, coef)
            elif self.mode == "scale":
                coef = torch.where(hit, scale, coef)
            else:
                coef = torch.where(hit, 0.0, coef)
                bc = g.entry(entries, "atk_bias_coef", 0.0)
                prev = entries.get("atk_bias")
                if "in" not in memo or memo["in"] is not prev:
                    memo["in"] = prev
                    memo["out"] = torch.where(
                        g.nodes[:, None], base,
                        torch.zeros_like(base) if prev is None else prev)
                entries = {**entries,
                           "atk_bias_coef": torch.where(hit, scale, bc),
                           "atk_bias": memo["out"]}
            return {**entries, "atk_coef": coef}

        return gen


@register_scenario("free_rider")
@dataclasses.dataclass(frozen=True)
class FreeRider:
    """Nodes that do no local work: their dx is zeroed every attacked round
    (``atk_work``). With ``stale=True`` they also emit their INITIAL (zero)
    state instead of the estimate they carry."""

    nodes: tuple
    start: int = 0
    stop: int | None = None
    stale: bool = False

    def apply(self, sched: dict, ctx: AttackContext) -> None:
        nodes = list(_resolve_nodes(self.nodes, None, ctx, 0))
        rows = _window(self.start, self.stop, ctx.rounds)
        work = _ensure_entry(sched, "work", ctx, 1.0)
        work[rows, nodes] = 0.0
        if self.stale:
            coef = _ensure_entry(sched, "coef", ctx, 1.0)
            coef[rows, nodes] = 0.0

    def stream_entry_names(self) -> tuple:
        return ("work", "coef") if self.stale else ("work",)

    def stream_entries(self, ctx: AttackContext):
        """Generative twin of ``apply`` (see ``Byzantine.stream_entries``)."""
        nodes = _resolve_nodes(self.nodes, None, ctx, 0)
        g = _Generator(nodes, _window(self.start, self.stop, ctx.rounds), ctx)
        stale = self.stale

        def gen(t, entries):
            hit = g.hit(t)
            work = g.entry(entries, "atk_work", 1.0)
            entries = {**entries, "atk_work": torch.where(hit, 0.0, work)}
            if stale:
                coef = g.entry(entries, "atk_coef", 1.0)
                entries = {**entries, "atk_coef": torch.where(hit, 0.0, coef)}
            return entries

        return gen


@register_scenario("link_corruption")
@dataclasses.dataclass(frozen=True)
class LinkCorruption:
    """Scale the payload crossing chosen DIRECTED edges (src -> dst):
    ``W[t, dst, src] *= scale`` in the materialized stack (scale=0 drops
    the link)."""

    edges: tuple                # ((src, dst), ...)
    scale: float = 0.0
    start: int = 0
    stop: int | None = None

    def apply(self, sched: dict, ctx: AttackContext) -> None:
        rows = _window(self.start, self.stop, ctx.rounds)
        # always a copy: the no-churn stack is a read-only broadcast view,
        # and the new identity tells apply_attacks that W was rewritten
        w = np.array(sched["w"])
        for src, dst in self.edges:
            src, dst = int(src), int(dst)
            if not (0 <= src < ctx.k and 0 <= dst < ctx.k):
                raise ValueError(f"link ({src}, {dst}) out of range "
                                 f"for K={ctx.k}")
            if src == dst:
                raise ValueError("link corruption targets edges, not the "
                                 "self term — use Byzantine for payloads")
            w[rows, dst, src] = w[rows, dst, src] * self.scale
        sched["w"] = w


@register_scenario("eavesdropper")
@dataclasses.dataclass(frozen=True)
class Eavesdropper:
    """Passive link tap: the driver records the tapped nodes' EMITTED
    payloads (after any Byzantine transform) each round into
    ``RunResult.taps`` (T, n_tap, d)."""

    nodes: tuple

    def apply(self, sched: dict, ctx: AttackContext) -> None:
        _resolve_nodes(self.nodes, None, ctx, 0)  # validate only


def _as_list(attacks) -> tuple:
    if attacks is None:
        return ()
    return tuple(attacks) if isinstance(attacks, (list, tuple)) \
        else (attacks,)


def apply_attacks(sched: dict, attacks, ctx: AttackContext
                  ) -> tuple[dict, AttackInfo]:
    """Run scenarios left to right over a materialized schedule. Returns
    the (shallow-copied) schedule and an ``AttackInfo``; ``atk_dishonest``
    (T, K) marks the cells whose wire payload differs from the state
    (``coef != 1`` or a bias injection)."""
    attacks = _as_list(attacks)
    sched = dict(sched)
    w_before = sched["w"]
    tap_nodes: list = []
    for atk in attacks:
        if not hasattr(atk, "apply"):
            raise TypeError(f"not an attack scenario: {atk!r} (want an "
                            "object with .apply(sched, ctx), e.g. from "
                            "repro_torch.attack.scenario())")
        atk.apply(sched, ctx)
        if isinstance(atk, Eavesdropper):
            tap_nodes.extend(int(n) for n in atk.nodes)
    if "atk_coef" in sched or "atk_bias_coef" in sched:
        dis = np.zeros((ctx.rounds, ctx.k), dtype=bool)
        if "atk_coef" in sched:
            dis |= sched["atk_coef"] != 1.0
        if "atk_bias_coef" in sched:
            dis |= sched["atk_bias_coef"] != 0.0
        sched["atk_dishonest"] = dis.astype(ctx.dtype)
    entry_names = tuple(n for n in ATTACK_ENTRY_NAMES
                        if "atk_" + n in sched)
    info = AttackInfo(
        token=tuple(repr(a) for a in attacks),
        entry_names=entry_names,
        tap_nodes=tuple(dict.fromkeys(tap_nodes)),  # dedupe, keep order
        w_modified=sched["w"] is not w_before,
    )
    return sched, info


def streamed_attacks(attacks, ctx: AttackContext):
    """Compose a scenario list into ONE generator for the streaming
    executor: ``part(t) -> {"atk_*": tensor}`` on ``ctx.device``, bitwise
    the rows ``apply_attacks`` would have stacked. Returns ``(part,
    info)``; scenarios without a generative form raise."""
    gens, names = [], set()
    for atk in _as_list(attacks):
        if not hasattr(atk, "stream_entries"):
            raise NotImplementedError(
                f"{type(atk).__name__} has no streamable (generative) form "
                "— it rewrites or records materialized schedule state. Run "
                "it on the stacked-schedule path (no participation "
                "streaming).")
        gens.append(atk.stream_entries(ctx))
        names.update(atk.stream_entry_names())
    if {"coef", "bias_coef"} & names:
        names.add("dishonest")
    entry_names = tuple(n for n in ATTACK_ENTRY_NAMES if n in names)
    dtype = torch.from_numpy(np.zeros((0,), ctx.dtype)).dtype

    def part(t):
        entries: dict = {}
        for g in gens:
            entries = g(t, entries)
        if "atk_coef" in entries or "atk_bias_coef" in entries:
            dis = None
            if "atk_coef" in entries:
                dis = entries["atk_coef"] != 1.0
            if "atk_bias_coef" in entries:
                bias = entries["atk_bias_coef"] != 0.0
                dis = bias if dis is None else dis | bias
            entries = {**entries, "atk_dishonest": dis.to(dtype)}
        return entries

    info = AttackInfo(
        token=tuple(repr(a) for a in _as_list(attacks)) + ("streamed",),
        entry_names=entry_names,
        tap_nodes=(),
        w_modified=False,
    )
    return part, info
