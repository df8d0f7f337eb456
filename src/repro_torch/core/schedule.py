"""Streamed per-round schedules and partial participation (client sampling).

A ``ScheduleProgram`` bundles named per-round generators — functions
``t -> {entry: tensor}`` whose randomness comes from a counter hash keyed
by (seed, t) (``repro_torch.core.streams``) — that the round-block executor
evaluates on the device for each round (``executor.run_round_blocks(
stream=...)``), so no (T, ...) schedule exists anywhere. The same program
can be ``materialize()``-d into the classical (T, ...) stacks; since every
entry is a function of (seed, t) alone, computed with the same ops on the
CPU and the card, the streamed and the materialized run see the same bits.

``SampleConfig`` is FedAvg-style partial participation (the elasticity
regime of CoLA §4): every round K' of the K nodes are drawn uniformly, the
top K' of K distinct 32-bit hashes. Two modes:

* ``dense``  — K <= ``DENSE_MAX_NODES``: the generator emits the round's
  ``active`` mask and mixing matrix ``w`` (the Metropolis weights of the
  complete graph's active subgraph are exactly 1/K' on the active block,
  and an inactive node keeps W_kk = 1), plus the dynamic certificate's
  entries and the leavers of ``leave_mode="reset"``, so the standard round
  body and the churn certificate run unchanged.
* ``cohort`` — million-node populations: the generator emits the sorted
  cohort indices ``cohort_idx`` (K',) and the ``active`` mask (K,); the
  round body gathers and updates only the (K', ...) cohort slices
  (``cola._run_cola_cohort``), and the certificate has a cohort mode
  (``metrics.CertificateRecorder(cohort=True)``).

Participation needs a complete base graph: the sampled subnetwork of a
sparse graph may disconnect, and its contraction factor has no closed form.

The port's draws are its own (the reference's threefry ``fold_in`` stream
cannot be reproduced in PyTorch): parity with the reference goes through
``participation_callable``, whose (T, K) masks the reference's churn run
takes as its ``active_schedule``. ``cohort_idx`` is int64 (torch's
``index_copy_`` and ``index_fill_`` take int64 indices), 8 bytes per
entry where the reference's int32 takes 4.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import streams

# auto mode takes the cohort path above this population: a dense (K, K)
# mixing matrix at 4,096 nodes is 64 MB of schedule per round
DENSE_MAX_NODES = 4096

# key slot of the participation draws, apart from the codec's ("samp")
_SAMPLE_STREAM = 0x73616D70


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Partial-participation sampler: K' of K nodes active per round.

    ``mode="auto"`` picks ``dense`` (full stacked state, streamed W) up to
    ``DENSE_MAX_NODES`` nodes and ``cohort`` (gather/scatter on the
    sampled indices, no (K, K) tensor anywhere) beyond. ``stream=False``
    evaluates the same generators into (T, ...) stacks up front, for the
    bitwise pins. ``seed=None`` derives the sampling key from the run seed.
    """

    k_active: int
    mode: str = "auto"          # "auto" | "dense" | "cohort"
    stream: bool = True
    seed: int | None = None

    def __post_init__(self):
        if self.k_active < 1:
            raise ValueError(f"need k_active >= 1, got {self.k_active}")
        if self.mode not in ("auto", "dense", "cohort"):
            raise ValueError(f"unknown participation mode {self.mode!r} "
                             "(want 'auto', 'dense' or 'cohort')")

    def resolve_mode(self, k: int) -> str:
        if self.k_active > k:
            raise ValueError(f"k_active={self.k_active} exceeds the "
                             f"population K={k}")
        if self.mode != "auto":
            return self.mode
        return "dense" if k <= DENSE_MAX_NODES else "cohort"

    def resolve_seed(self, run_seed: int) -> int:
        return int(run_seed if self.seed is None else self.seed)


class EntryStruct(NamedTuple):
    """Shape and dtype of one round's streamed entry."""

    shape: tuple
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class ScheduleProgram:
    """Named per-round schedule generators.

    ``parts`` is a tuple of functions ``t -> {name: tensor}`` whose outputs
    merge left to right into the round's schedule slice. The program
    streams (``stream_fn``, what the executor's ``stream=`` takes) or
    materializes (``materialize``, the (T, ...) stacks).
    """

    parts: tuple

    def stream_fn(self) -> Callable[[int], dict]:
        parts = self.parts

        def stream(t: int) -> dict:
            out: dict = {}
            for p in parts:
                out.update(p(t))
            return out

        return stream

    def entry_structs(self) -> dict:
        """{name: EntryStruct} of one round's entries (round 0 evaluated)."""
        return {name: EntryStruct(tuple(v.shape), v.dtype)
                for name, v in self.stream_fn()(0).items()}

    def materialize(self, rounds: int) -> dict:
        """The generators evaluated for rounds 0..T-1, stacked into host
        (T, ...) numpy arrays: bitwise the values the streamed run derives
        round by round."""
        fn = self.stream_fn()
        structs = self.entry_structs()
        cols: dict = {name: [] for name in structs}
        for t in range(rounds):
            for name, val in fn(t).items():
                cols[name].append(val.cpu().numpy())
        return {name: np.stack(vals) if vals else
                np.zeros((0,) + structs[name].shape,
                         torch.empty((), dtype=structs[name].dtype)
                         .numpy().dtype)
                for name, vals in cols.items()}

    def footprint(self, rounds: int) -> dict:
        """Streamed against stacked schedule memory, bytes: ``streamed`` is
        one round's entries, ``stacked`` the (T, ...) alternative."""
        per_round = {name: int(np.prod(sd.shape, dtype=np.int64))
                     * sd.dtype.itemsize
                     for name, sd in self.entry_structs().items()}
        streamed = int(sum(per_round.values()))
        return {"entries": per_round, "streamed_bytes": streamed,
                "stacked_bytes": streamed * int(rounds)}


def sample_key(sample: SampleConfig, run_seed: int) -> int:
    """The 32-bit key of a run's participation draws."""
    return streams.fold(_SAMPLE_STREAM, sample.resolve_seed(run_seed))


def _top(key: int, t: int, k: int, k_active: int, device) -> torch.Tensor:
    # K distinct 32-bit hashes of round t: the top k_active are a uniform
    # K'-subset, the same set on every device (no ties to break)
    h = streams.bits(streams.fold(key, t), (k,), device)
    return torch.topk(h, k_active).indices


def active_mask(key: int, t: int, k: int, k_active: int,
                device) -> torch.Tensor:
    """(K,) bool participation mask of round ``t``: a uniformly random
    K'-subset, re-derivable at any round without sampler state."""
    idx = _top(key, t, k, k_active, device)
    return torch.zeros((k,), dtype=torch.bool,
                       device=device).index_fill_(0, idx, True)


def cohort_indices(key: int, t: int, k: int, k_active: int,
                   device) -> torch.Tensor:
    """(K',) sorted int64 active-node indices of round ``t``: the same draw
    as ``active_mask``, in gather order."""
    return torch.sort(_top(key, t, k, k_active, device)).values


def sampled_complete_weights(mask: torch.Tensor, k_active: int,
                             dtype) -> torch.Tensor:
    """Metropolis mixing matrix of the complete graph's active subgraph:
    1/K' between active nodes (self included; the induced subgraph is
    complete, so the weights are the exact uniform average), and W_kk = 1
    for an inactive node (frozen, as ``topology.reweight_for_active``
    builds it)."""
    m = mask.to(dtype)
    return torch.outer(m, m) * (1.0 / k_active) + torch.diag(1.0 - m)


def require_complete(graph) -> None:
    if getattr(graph, "name", None) != "complete":
        raise ValueError(
            "participation= requires a complete base graph (topology "
            f"{getattr(graph, 'name', type(graph).__name__)!r}): the "
            "sampled subnetwork of a sparse graph may disconnect and its "
            "contraction factor has no closed form")


def cohort_grad_thresh(cert) -> float:
    """The Eq.-10 threshold over a sampled COMPLETE subnetwork: its mixing
    matrix is the exact uniform average (rank one), so beta = 0 and the
    dynamic threshold is a run constant."""
    n_sizes = np.sum(cert.masks.cpu().numpy(), axis=1)
    scale = float(np.sum(n_sizes ** 2 * cert.sigma_k.cpu().numpy()))
    k = cert.part.num_nodes
    return float((scale ** -0.5) / (2.0 * cert.l_bound * np.sqrt(float(k)))
                 * cert.eps)


def participation_parts(k: int, sample: SampleConfig, *, dtype, run_seed: int,
                        device, cert=None, leave_reset: bool = False
                        ) -> tuple:
    """The dense-mode generator parts: the active mask and mixing matrix;
    with ``cert`` the dynamic certificate's entries (``cert_mask``, the
    self-inclusive support of the round's W, and ``cert_grad_thresh``,
    ``cohort_grad_thresh``); with ``leave_reset`` the ``leavers`` (K,)
    bool. The host flag ``reset_any`` comes from ``reset_flags``, so that
    the driver gates the reset without a device sync."""
    key = sample_key(sample, run_seed)
    k_active = sample.k_active
    mask_at = lambda t: active_mask(key, t, k, k_active, device)

    def part_mix(t):
        mask = mask_at(t)
        return {"active": mask.to(dtype),
                "w": sampled_complete_weights(mask, k_active, dtype)}

    parts = [part_mix]
    if cert is not None:
        thresh = torch.tensor(cohort_grad_thresh(cert), dtype=dtype,
                              device=device)
        eye = torch.eye(k, dtype=torch.bool, device=device)

        def part_cert(t):
            mask = mask_at(t)
            cmask = torch.outer(mask, mask) | eye
            return {"cert_mask": cmask.to(dtype), "cert_grad_thresh": thresh}

        parts.append(part_cert)
    if leave_reset:
        ones = torch.ones((k,), dtype=torch.bool, device=device)

        def part_reset(t):
            prev = ones if t == 0 else mask_at(t - 1)
            return {"leavers": prev & ~mask_at(t)}

        parts.append(part_reset)
    return tuple(parts)


def reset_flags(k: int, sample: SampleConfig, run_seed: int,
                rounds: int) -> np.ndarray:
    """(T,) bool on the host: whether round t has a leaver (a node active
    in round t-1, all nodes before round 0, and inactive in t). The same
    counter stream as the device's ``leavers``, evaluated on the CPU."""
    key = sample_key(sample, run_seed)
    out = np.zeros((rounds,), dtype=bool)
    prev = np.ones((k,), dtype=bool)
    for t in range(rounds):
        cur = active_mask(key, t, k, sample.k_active, "cpu").numpy()
        out[t] = bool((prev & ~cur).any())
        prev = cur
    return out


def cohort_parts(k: int, sample: SampleConfig, *, dtype, run_seed: int,
                 device) -> tuple:
    """The cohort-mode generator part: the sorted cohort indices (what the
    gather/scatter round body reads) and the (K,) mask the certificate
    uses to tell active from frozen nodes."""
    key = sample_key(sample, run_seed)
    k_active = sample.k_active

    def part(t):
        idx = cohort_indices(key, t, k, k_active, device)
        mask = torch.zeros((k,), dtype=dtype,
                           device=device).index_fill_(0, idx, 1.0)
        return {"cohort_idx": idx, "active": mask}

    return (part,)


def participation_callable(k: int, sample: SampleConfig,
                           run_seed: int) -> Callable:
    """An ``active_schedule(t, rng)`` callable that replays the sampler's
    draws on the host (it ignores the shared schedule rng): what the
    loop driver and a churn run of either package take in place of the
    streamed generator."""
    key = sample_key(sample, run_seed)

    def schedule(t, rng):
        return active_mask(key, t, k, sample.k_active, "cpu").numpy()

    return schedule


def render_stream_footprint(k: int, k_active: int, rounds: int, d: int, *,
                            seed: int = 0, dtype=torch.float32) -> str:
    """Human-readable streamed-schedule footprint: the bytes of each entry
    resident per round against the (T, ...) stacks streaming replaces.
    Uses the cohort generator above ``DENSE_MAX_NODES``, as ``run_cola``
    would."""
    sample = SampleConfig(k_active=k_active)
    mode = sample.resolve_mode(k)
    make = cohort_parts if mode == "cohort" else participation_parts
    prog = ScheduleProgram(parts=make(k, sample, dtype=dtype, run_seed=seed,
                                      device="cpu"))
    fp = prog.footprint(rounds)
    lines = [f"[streamed schedule] K={k:,} K'={k_active:,} T={rounds:,} "
             f"mode={mode} (schedule bytes resident per round)"]
    for name, b in sorted(fp["entries"].items()):
        lines.append(f"  {name:<12} {b:>14,} B/round")
    lines.append(f"  {'streamed':<12} {fp['streamed_bytes']:>14,} B total "
                 "(resident per round)")
    lines.append(f"  {'stacked':<12} {fp['stacked_bytes']:>14,} B total "
                 "(the (T, ...) alternative)")
    return "\n".join(lines)
