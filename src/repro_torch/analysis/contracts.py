"""Comm contracts: declared collective budgets checked against counted ones.

A ``CommContract`` is the static half of the paper's communication model:
what one COLA program is ALLOWED to move per rank. The reference holds a
lowered program's HLO to it; an eager program has no HLO, so ``check_comm``
holds a report of what the program actually sent to it: the collective
calls and bytes a ``NodeAxis`` counted over the ranks
(``launch.op_analysis.axis_report``), or ``op_analysis.analyze``'s report
of a traced program. This is the one place the "plan paths never gather,
certificates exchange O(d)" guarantees are enforced.

Contracts come from the objects that know their own budget
(``CommPlan.contract()`` / ``BlockPlan.contract()`` in
``repro_torch.topo.plan``) or from the helpers below for the runtime paths
that have no plan object (ring mixing, certificate recorders, gather
oracles).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

#: collective kinds a neighbor-only program must not issue at all
FORBID_NEIGHBOR_ONLY: Tuple[str, ...] = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all")


class CommContractViolation(AssertionError):
    """A program exceeded its declared collective budget."""


@dataclasses.dataclass(frozen=True)
class CommContract:
    """Per-rank collective budget of one program.

    All byte bounds are per-rank totals over the whole program, in the
    reference's accounting: all-reduce bytes count x2 (reduce +
    broadcast), all-gather bytes are the gathered result a rank holds.

    Attributes:
      name: label for failure messages (e.g. ``plan-K4-c3``).
      forbid: collective kinds that must move ZERO bytes.
      max_collective_permute_bytes: per-rank exchange payload cap, or None.
      max_collective_permute_count: executed exchange cap, or None.
      require_collective_permute: the program must actually exchange
        (count > 0 and bytes > 0) — guards against vacuously-passing
        programs that lost their exchanges.
      max_all_reduce_bytes: scalar/O(d) psum allowance (certificate
        recorders), or None. Only meaningful when "all-reduce" is not in
        ``forbid``.
      min_all_gather_bytes: floor for paths that MUST gather (the dense
        oracle contrast assertions), or None.
      min_total_bytes: floor on total collective bytes (gather-recorder
        contrast), or None.
    """

    name: str
    forbid: Tuple[str, ...] = FORBID_NEIGHBOR_ONLY
    max_collective_permute_bytes: float | None = None
    max_collective_permute_count: float | None = None
    require_collective_permute: bool = False
    max_all_reduce_bytes: float | None = None
    min_all_gather_bytes: float | None = None
    min_total_bytes: float | None = None

    def describe(self) -> str:
        """One-line budget summary (the ``dryrun --plan`` contract line)."""
        parts = []
        if self.max_collective_permute_count is not None:
            parts.append(
                f"<={int(self.max_collective_permute_count)} "
                "collective-permute(s)")
        if self.max_collective_permute_bytes is not None:
            parts.append(
                f"<={int(self.max_collective_permute_bytes):,} "
                "ppermute bytes/device")
        if self.max_all_reduce_bytes is not None:
            parts.append(
                f"all-reduce<={int(self.max_all_reduce_bytes):,}B")
        if self.forbid:
            parts.append("zero " + "/".join(self.forbid))
        if self.min_all_gather_bytes is not None:
            parts.append(f"all-gather>={int(self.min_all_gather_bytes):,}B")
        if self.min_total_bytes is not None:
            parts.append(f"total>={int(self.min_total_bytes):,}B")
        return f"[contract {self.name}] " + ", ".join(parts)

    def check(self, calls: dict, sent: dict) -> None:
        """Raise ``CommContractViolation`` unless one rank's counts of a
        gossip round (``calls`` and ``sent`` bytes by ``NodeAxis`` kind, as
        its ``counts`` / ``sent_bytes`` hold them) meet the exchange
        budget and call none of the ``forbid`` kinds.
        ``require_collective_permute`` is the program's promise across
        ranks, not checked here: one rank may be unmatched in every color
        (a block plan at M = 1 has none)."""
        bad = []
        n_perm, b_perm = calls.get("permute", 0), sent.get("permute", 0)
        if (self.max_collective_permute_count is not None
                and n_perm > self.max_collective_permute_count):
            bad.append(f"{n_perm} permutes > "
                       f"{self.max_collective_permute_count}")
        if (self.max_collective_permute_bytes is not None
                and b_perm > self.max_collective_permute_bytes):
            bad.append(f"{b_perm} permute bytes > "
                       f"{self.max_collective_permute_bytes}")
        for kind in self.forbid:
            if calls.get(kind, 0):
                bad.append(f"{calls[kind]} {kind} call(s)")
        if bad:
            raise CommContractViolation(f"{self.describe()} violated: "
                                        + "; ".join(bad))


def check_comm(report, contract: CommContract) -> dict:
    """Hold a program's collectives to its declared budget.

    ``report``: a dict with the reference's keys (``collectives`` and
    ``collective_counts`` by kind), as ``op_analysis.axis_report`` gives
    them for a ``NodeAxis``'s counts (and ``op_analysis.analyze`` for a
    traced program). A ``NodeAxis`` report also carries ``broadcast``, a
    kind the reference's programs never issue: it is forbidden wherever
    all-gather is (it too moves a whole tensor to every rank).

    Returns the report on success; raises ``CommContractViolation``
    listing every violated clause (with the per-kind byte / count tables)
    otherwise.
    """
    coll, counts = report["collectives"], report["collective_counts"]
    bad = []
    forbid = tuple(contract.forbid) + (
        ("broadcast",) if "all-gather" in contract.forbid else ())
    for kind in forbid:
        if coll.get(kind, 0) != 0 or counts.get(kind, 0) != 0:
            bad.append(f"forbidden {kind}: {coll.get(kind, 0):,.0f} bytes "
                       f"(must be 0)")
    cp_bytes = coll.get("collective-permute", 0)
    cp_count = counts.get("collective-permute", 0)
    if contract.max_collective_permute_bytes is not None \
            and cp_bytes > contract.max_collective_permute_bytes:
        bad.append(
            f"collective-permute moves {cp_bytes:,.0f} bytes/device > "
            f"budget {contract.max_collective_permute_bytes:,.0f}")
    if contract.max_collective_permute_count is not None \
            and cp_count > contract.max_collective_permute_count:
        bad.append(
            f"{cp_count:.0f} collective-permutes executed > budget "
            f"{contract.max_collective_permute_count:.0f}")
    if contract.require_collective_permute and not (
            cp_count > 0 and cp_bytes > 0):
        bad.append("no collective-permute executed: the program lost its "
                   "neighbor exchange (count "
                   f"{cp_count:.0f}, bytes {cp_bytes:,.0f})")
    if contract.max_all_reduce_bytes is not None \
            and coll.get("all-reduce", 0) > contract.max_all_reduce_bytes:
        bad.append(
            f"all-reduce moves {coll['all-reduce']:,.0f} bytes > allowance "
            f"{contract.max_all_reduce_bytes:,.0f}")
    if contract.min_all_gather_bytes is not None \
            and coll.get("all-gather", 0) < contract.min_all_gather_bytes:
        bad.append(
            f"all-gather moves {coll.get('all-gather', 0):,.0f} bytes < "
            f"required {contract.min_all_gather_bytes:,.0f} (this path "
            "MUST gather)")
    if contract.min_total_bytes is not None \
            and coll.get("total", 0) < contract.min_total_bytes:
        bad.append(
            f"total collective bytes {coll.get('total', 0):,.0f} < required "
            f"{contract.min_total_bytes:,.0f}")
    if bad:
        raise CommContractViolation(
            f"{contract.describe()}\n  " + "\n  ".join(bad)
            + f"\n  bytes={ {k: v for k, v in coll.items()} }"
            + f"\n  counts={ {k: v for k, v in counts.items()} }")
    return report


# -- runtime paths without a plan object ------------------------------------

def ring_contract(d: int, conn: int = 1, itemsize: int = 4, *,
                  gossip_steps: int = 1) -> CommContract:
    """Budget of the banded ring (``comm="ring"``): 2*conn exchanges of a
    (d,) payload per gossip step, nothing gathered."""
    return CommContract(
        name=f"ring-conn{conn}-d{d}",
        max_collective_permute_count=gossip_steps * 2 * conn,
        max_collective_permute_bytes=gossip_steps * 2 * conn * d * itemsize,
        require_collective_permute=True)


def certificate_contract(d: int, conn: int = 1,
                         itemsize: int = 4) -> CommContract:
    """The O(d) certificate-record budget (Prop. 1 exchange): neighbor
    payloads over <= 2*conn exchanges, scalar row reductions plus the
    (2, d) invariant-sum psum — never a K*d gather. The reference's cap,
    which leaves room for XLA lowering that psum twice."""
    return CommContract(
        name=f"certificate-conn{conn}-d{d}",
        forbid=("all-gather", "reduce-scatter", "all-to-all"),
        max_collective_permute_bytes=2 * conn * d * itemsize,
        max_all_reduce_bytes=(4 * d + 64) * itemsize)


def gather_contract(name: str, *, min_all_gather_bytes: float | None = None,
                    min_total_bytes: float | None = None) -> CommContract:
    """Contrast contract for paths that MUST move the stacks (the dense
    oracle, the gather-``GapRecorder``) — proves the counts would see the
    collectives a plan path is asserted not to have."""
    return CommContract(name=name, forbid=(),
                        min_all_gather_bytes=min_all_gather_bytes,
                        min_total_bytes=min_total_bytes)
