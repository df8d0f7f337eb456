"""Pluggable recording/control layer for the round-block executor.

A Recorder bundles what to measure each record round, what the columns are
called, and when the run may stop early (duck-typed, no base class):

  labels      tuple[str, ...] — column names; the history dict keys.
  record_fn   state -> (len(labels),) row tensor on the state's device;
              ``record_fn(state, sched_t)`` when ``uses_schedule`` is set
              (the round's schedule slice, e.g. the churn certificate's
              ``cert_mask`` / ``cert_grad_thresh``).
  stop_fn     None (never stop) or row -> 0-d bool tensor; evaluated only
              on record rounds, so ``record_every`` is also the
              certification cadence.

Implementations: ``GapRecorder`` (the Lemma-2 ``gap_report`` row),
``CertificateRecorder`` (the Prop.-1 local certificates, on the static
graph, ``dynamic`` on each churn round's reweighted exchange, or
``cohort`` on each round's sampled cohort of a complete graph),
``ComposedRecorder`` (concatenated rows, stops when any part stops) and
``FnRecorder`` (a bare row function). ``attackify`` makes the certificate
audit the honest cohort of an attacked run.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import topology as topo
from repro_torch.core.duality import (block_spectral_norms,
                                      certificate_thresholds,
                                      consensus_residual, gap_report,
                                      neighbor_mask, neighborhood_mean,
                                      node_subproblem_gaps)
from repro_torch.core.partition import Partition
from repro_torch.obs import trace as obs_trace

GAP_METRICS = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")
CERT_METRICS = ("local_gap_max", "grad_disagreement_max", "cond9_nodes",
                "cond10_nodes", "certified", "consensus_residual",
                "certificate_violated")


@dataclasses.dataclass(frozen=True)
class AdaptiveCadence:
    """Record-cadence controller: geometric back-off.

    Doubles the cadence after each record round whose distance ratio
    (``recorder.cadence_ratio(row)``) is above ``near``, and snaps back to
    ``base`` the moment a row lands inside the ``near`` band. The block
    executor runs it on the device; the loop executor runs the identical
    integer arithmetic on the host.
    """

    base: int = 1        # cadence inside the near band
    max_every: int = 64  # back-off cap
    grow: int = 2        # geometric factor per far record round
    near: float = 2.0    # "near" band: ratio <= near tightens to base

    def __post_init__(self):
        if self.base < 1 or self.grow < 2 or self.max_every < self.base:
            raise ValueError(
                f"need base >= 1, grow >= 2, max_every >= base; got {self}")


def as_cadence(record_every) -> AdaptiveCadence | None:
    """An int keeps the fixed host-side mask; ``"adaptive"`` or an
    ``AdaptiveCadence`` arms the controller."""
    if isinstance(record_every, AdaptiveCadence):
        return record_every
    if record_every == "adaptive":
        return AdaptiveCadence()
    return None


@dataclasses.dataclass(frozen=True)
class GapRecorder:
    """Lemma-2 global diagnostics (the ``gap_report`` row)."""

    problem: Any
    part: Partition
    eps: float | None = None

    labels = GAP_METRICS

    def record_fn(self, state) -> torch.Tensor:
        rep = gap_report(self.problem, self.part, state.x_parts,
                         state.v_stack)
        return torch.stack([getattr(rep, name) for name in self.labels])

    @property
    def stop_fn(self) -> Callable | None:
        if self.eps is None:
            return None
        eps, idx = self.eps, self.labels.index("gap")
        return lambda row: row[idx] <= eps

    def cadence_ratio(self, row) -> torch.Tensor:
        """Distance-to-stop ratio for ``AdaptiveCadence``: gap / eps."""
        if self.eps is None:
            raise ValueError("adaptive record cadence needs eps= on the gap "
                             "recorder (the ratio is gap / eps)")
        return row[self.labels.index("gap")] / self.eps

    def init_spec(self) -> dict:
        """The recorder's per-run state, for the dry run's placement
        (``dist.sharding.cola_recorder_pspecs``): none."""
        return {}

    def collective_footprint(self, k: int, d: int, n_k: int,
                             itemsize: int = 4, comm: str = "dense",
                             conn: int = 1) -> dict:
        """Bytes per rank per record round by collective kind, one node per
        rank (the reference's accounting, ``render_footprints``)."""
        # the gathered (K, n_k) and (K, d) stacks, plus scalar reductions
        # for the row
        return {"all-gather": k * (d + n_k) * itemsize,
                "all-reduce": 2 * len(self.labels) * itemsize,
                "collective-permute": 0}


@dataclasses.dataclass(frozen=True)
class CertificateRecorder:
    """Prop.-1 local certificates as an on-device metric row.

    All round-invariant inputs (sigma_k, the Eq.-9/10 thresholds, the
    self-inclusive neighbor mask) are resolved at construction — see
    ``certificate_recorder``. ``stop_fn`` fires at certification. Under
    churn (``dynamic``, see ``dynamize``) the Eq.-10 neighbor mask and
    threshold come from the round's schedule instead (``cert_mask``,
    ``cert_grad_thresh``: the support of the reweighted W_t and beta of the
    active subnetwork, ``certificate_schedule``). In ``cohort`` mode
    (client sampling over a complete graph, ``cohort_certificate_recorder``)
    the Eq.-10 neighborhood is the round's sampled cohort: its mixing is
    the exact uniform average, so the neighborhood mean is one cohort-mean
    broadcast (no (K, K) mask anywhere) and the threshold is the beta = 0
    run constant ``grad_thresh``; the schedule gives ``cohort_idx`` (K',)
    and ``active`` (K,), and a frozen node keeps its own gradient as its
    neighborhood mean (disagreement 0), as a churn round isolates it.

    ``attack_aware`` (``attackify``) audits the HONEST COHORT of an
    attacked run: it reads the schedule's ground-truth per-round
    dishonesty mask ``atk_dishonest`` (what the harness injected, never
    visible to the defense) and restricts every certificate input to the
    honest nodes: the Lemma-1 sums, conditions (9) and (10), and the
    Eq.-10 neighborhood mean (a dishonest node leaves every neighborhood).
    Under the trim defense with a symmetric W the cohort invariant
    sum_H v_k = K A_H x_H holds exactly whenever the gate rejects every
    lie, so a defended run certifies while an undefended one trips
    ``certificate_violated``.
    """

    problem: Any
    part: Partition
    a_parts: torch.Tensor      # (K, d, n_k)
    gp_parts: torch.Tensor     # (K, n_k)
    masks: torch.Tensor        # (K, n_k)
    # (K, K) 0/1 self-inclusive neighbor mask; None in cohort mode
    neigh_mask: torch.Tensor | None
    sigma_k: torch.Tensor      # (K,) spectral-norm cache
    eps: float
    beta_ub: float
    l_bound: float
    gap_thresh: float
    grad_thresh: float
    stop_on_certified: bool = True
    dynamic: bool = False
    # Lemma-1 tamper detection: certifying also requires the relative
    # invariant residual <= cons_tol; residual > viol_tol (or non-finite)
    # raises ``certificate_violated``.
    cons_tol: float = 1e-2
    viol_tol: float = 0.1
    stop_on_violation: bool = False
    attack_aware: bool = False
    cohort: bool = False

    labels = CERT_METRICS

    @property
    def uses_schedule(self) -> bool:
        return self.dynamic or self.attack_aware or self.cohort

    def record_fn(self, state, sched=None) -> torch.Tensor:
        with obs_trace.span("record.certificate"):
            return self._record(state, sched)

    def _record(self, state, sched) -> torch.Tensor:
        if self.cohort:
            return self._cohort_record(state, sched)
        v_stack, x_parts = state.v_stack, state.x_parts
        grads = self.problem.grad_f(v_stack)                     # (K, d)
        if self.dynamic:
            mask = sched["cert_mask"]
            grad_thresh = sched["cert_grad_thresh"]
        else:
            mask, grad_thresh = self.neigh_mask, self.grad_thresh
        hon = None
        if self.attack_aware:
            hon = (sched["atk_dishonest"] <= 0).to(v_stack.dtype)
            # dishonest nodes leave every neighborhood mean: their emitted
            # information is what the defense discards
            mask = mask * hon[None, :]
        return self._row(state, grads, neighborhood_mean(grads, mask),
                         grad_thresh, honest=hon)

    def _cohort_record(self, state, sched) -> torch.Tensor:
        """Cohort-mode row: the Eq.-9 gaps and the Lemma-1 sums over the
        whole population (a frozen node must still meet condition 9, as
        under churn), the Eq.-10 neighborhood mean one cohort mean."""
        grads = self.problem.grad_f(state.v_stack)               # (K, d)
        cohort_mean = torch.mean(grads[sched["cohort_idx"]], dim=0)
        act = sched["active"] > 0
        neigh_mean = torch.where(act[:, None], cohort_mean[None, :], grads)
        return self._row(state, grads, neigh_mean, None)

    def _row(self, state, grads, neigh_mean, grad_thresh,
             honest=None) -> torch.Tensor:
        v_stack, x_parts = state.v_stack, state.x_parts
        local_gap, disagree = self.local_row_inputs(x_parts, v_stack, grads,
                                                    neigh_mean)
        v_sum, ax_sum = self.invariant_sums(x_parts, v_stack, honest)
        resid = consensus_residual(v_sum, ax_sum, self.part.num_nodes)
        return self.summarize(local_gap, disagree, resid=resid,
                              grad_thresh=grad_thresh, honest=honest)

    def local_row_inputs(self, x_parts, v_stack, grads, neigh_mean):
        """(local_gap, disagreement) per node, shared by the stacked row
        and the distributed runtime's (which passes its node block, with
        the recorder's blocks swapped for its own, and a neighborhood mean
        from its exchanges)."""
        local_gap = node_subproblem_gaps(self.problem, x_parts, v_stack,
                                         self.a_parts, self.gp_parts,
                                         self.masks, grads)
        disagree = torch.linalg.vector_norm(grads - neigh_mean, dim=1)
        return local_gap, disagree

    def invariant_sums(self, x_parts, v_stack, honest=None):
        """[sum_k v_k, sum_k A_[k] x_[k]], the Lemma-1 residual's inputs;
        ``honest`` (0/1, attack-aware mode) restricts both sums to the
        honest cohort, whose invariant a working defense preserves."""
        if honest is not None:
            x_parts = x_parts * honest[:, None]
            v_stack = v_stack * honest[:, None]
        return (torch.sum(v_stack, dim=0),
                torch.bmm(self.a_parts, x_parts.unsqueeze(-1)).sum(dim=(0, 2)))

    def summarize(self, local_gap, disagree, *, resid,
                  grad_thresh=None, honest=None, psum=None,
                  pmax=None) -> torch.Tensor:
        """Assemble the scalar row from per-node quantities.
        ``grad_thresh`` overrides the static Eq.-10 threshold (the churn
        round's value). ``honest`` (attack-aware mode, 0/1 per node)
        restricts conditions (9) and (10) and their maxima to the honest
        nodes; certifying then needs every HONEST node to meet both.
        ``psum`` / ``pmax`` (default: none) complete the counts and maxima
        across ranks when the per-node inputs are one rank's block."""
        psum = psum if psum is not None else (lambda t: t)
        pmax = pmax if pmax is not None else (lambda t: t)
        dtype = local_gap.dtype
        if grad_thresh is None:
            grad_thresh = self.grad_thresh
        cond9 = local_gap <= self.gap_thresh
        cond10 = disagree <= grad_thresh
        if honest is None:
            n_target = float(self.part.num_nodes)
        else:
            ok = honest > 0
            cond9, cond10 = cond9 & ok, cond10 & ok
            local_gap = torch.where(ok, local_gap, 0.0)
            disagree = torch.where(ok, disagree, 0.0)
            n_target = psum(torch.sum(honest.to(dtype)))
        n9 = psum(torch.sum(cond9.to(dtype)))
        n10 = psum(torch.sum(cond10.to(dtype)))
        n_both = psum(torch.sum((cond9 & cond10).to(dtype)))
        resid = resid.to(dtype)
        certified = ((n_both == n_target)
                     & (resid <= self.cons_tol)).to(dtype)
        violated = ((resid > self.viol_tol)
                    | ~torch.isfinite(resid)).to(dtype)
        return torch.stack([pmax(torch.max(local_gap)),
                            pmax(torch.max(disagree)),
                            n9, n10, certified, resid, violated])

    @property
    def stop_fn(self) -> Callable | None:
        idx_c = self.labels.index("certified")
        idx_v = self.labels.index("certificate_violated")
        if self.stop_on_certified and self.stop_on_violation:
            return lambda row: (row[idx_c] > 0) | (row[idx_v] > 0)
        if self.stop_on_certified:
            return lambda row: row[idx_c] > 0
        if self.stop_on_violation:
            return lambda row: row[idx_v] > 0
        return None

    def cadence_ratio(self, row) -> torch.Tensor:
        """Distance-to-certification: the worse of the two margins. Uses
        the static thresholds in ``dynamic`` mode too: the cadence is a
        scheduling heuristic, certification itself reads the round's."""
        gap_r = row[self.labels.index("local_gap_max")] / self.gap_thresh
        dis_r = (row[self.labels.index("grad_disagreement_max")]
                 / self.grad_thresh)
        return torch.maximum(gap_r, dis_r)

    def init_spec(self) -> dict:
        """The per-run state: ``sigma_k`` (K,) and, where it has one, the
        self-inclusive neighbour mask (K, K)."""
        if self.neigh_mask is None:
            return {"sigma_k": self.sigma_k}
        return {"sigma_k": self.sigma_k, "neigh_mask": self.neigh_mask}

    def collective_footprint(self, k: int, d: int, n_k: int,
                             itemsize: int = 4, comm: str = "dense",
                             conn: int = 1) -> dict:
        """Bytes per rank per record round, one node per rank: scalar
        psums and the one stacked (2, d) Lemma-1 invariant psum
        (``invariant_sums``), O(d); on the ring 2*conn exchanges of one
        (d,) gradient, on the dense fallback the round body's gather."""
        scalars = (2 * len(self.labels) + 3) * itemsize + 2 * d * itemsize
        if comm == "ring":
            return {"all-gather": 0, "all-reduce": scalars,
                    "collective-permute": 2 * conn * d * itemsize}
        return {"all-gather": k * d * itemsize, "all-reduce": scalars,
                "collective-permute": 0}


@dataclasses.dataclass(frozen=True)
class ComposedRecorder:
    """Concatenate several recorders into one row; stop when ANY part's stop
    condition fires. Labels must be pairwise disjoint."""

    parts: tuple

    def __post_init__(self):
        labels = self.labels
        if len(set(labels)) != len(labels):
            raise ValueError(f"composed recorder labels collide: {labels}")

    @property
    def labels(self):
        return tuple(lbl for p in self.parts for lbl in p.labels)

    @property
    def uses_schedule(self) -> bool:
        return any(getattr(p, "uses_schedule", False) for p in self.parts)

    def record_fn(self, state, sched=None) -> torch.Tensor:
        return torch.cat([
            p.record_fn(state, sched)
            if getattr(p, "uses_schedule", False) else p.record_fn(state)
            for p in self.parts])

    def _slices(self):
        off = 0
        for p in self.parts:
            yield p, off, off + len(p.labels)
            off += len(p.labels)

    @property
    def stop_fn(self) -> Callable | None:
        stops = [(a, b, p.stop_fn) for p, a, b in self._slices()
                 if p.stop_fn is not None]
        if not stops:
            return None

        def stop(row):
            out = stops[0][2](row[stops[0][0]:stops[0][1]])
            for a, b, fn in stops[1:]:
                out = out | fn(row[a:b])
            return out

        return stop

    def cadence_ratio(self, row) -> torch.Tensor:
        """Min over the parts' ratios: the part closest to stopping drives
        the cadence."""
        ratios = []
        for p, a, b in self._slices():
            if hasattr(p, "cadence_ratio"):
                try:
                    ratios.append(p.cadence_ratio(row[a:b]))
                except ValueError:  # e.g. gap part without eps: no opinion
                    pass
        if not ratios:
            raise ValueError("adaptive cadence needs at least one part with "
                             "a cadence_ratio (gap-with-eps or certificate)")
        out = ratios[0]
        for r in ratios[1:]:
            out = torch.minimum(out, r)
        return out

    def init_spec(self) -> dict:
        return {f"part{i}": p.init_spec() for i, p in enumerate(self.parts)}

    def collective_footprint(self, k, d, n_k, itemsize=4, comm="dense",
                             conn=1) -> dict:
        out: dict = {}
        for p in self.parts:
            for kind, b in p.collective_footprint(
                    k, d, n_k, itemsize, comm, conn).items():
                out[kind] = out.get(kind, 0) + b
        return out


@dataclasses.dataclass(frozen=True)
class FnRecorder:
    """Ad-hoc recorder from a bare row function; ``stop`` is an optional
    row -> bool."""

    labels: tuple
    fn: Callable
    stop: Callable | None = None

    def record_fn(self, state) -> torch.Tensor:
        return self.fn(state)

    @property
    def stop_fn(self) -> Callable | None:
        return self.stop

    def init_spec(self) -> dict:
        return {}

    def collective_footprint(self, k, d, n_k, itemsize=4, comm="dense",
                             conn=1) -> dict:
        return {"all-gather": 0, "all-reduce": 0, "collective-permute": 0}


def _l_bound(problem) -> float:
    """The problem's L (the bound on g_i's support), which Prop. 1 needs
    finite."""
    l_bound = float(problem.l_bound)
    if not math.isfinite(l_bound):
        raise ValueError(
            f"problem {problem.name!r} has unbounded g_i support "
            "(l_bound=inf): Prop. 1 needs an L-bounded problem "
            "(lasso / box-constrained) — use the gap recorder instead")
    return l_bound


def certificate_recorder(problem, part: Partition, env, neighbors,
                         eps: float, *, w=None, sigma_k=None,
                         stop_on_certified: bool = True,
                         cons_tol: float = 1e-2, viol_tol: float = 0.1,
                         stop_on_violation: bool = False
                         ) -> CertificateRecorder:
    """Build a ``CertificateRecorder``, resolving every round-invariant input.

    Args:
      env: the ``ColaEnv`` (supplies a_parts / gp_parts / masks; a rank's
        block of them over ``repro_torch.dist``, with ``sigma_k`` then
        given for all K nodes).
      neighbors: adjacency (or mixing matrix, or a Topology) whose support
        defines N_k.
      w: the mixing matrix for the contraction bound beta; defaults to
        Metropolis weights over ``neighbors`` when it is a Topology.
      sigma_k: optional precomputed (K,) ``block_spectral_norms`` values
        (array-like), e.g. the same constants another implementation used.
    """
    if isinstance(neighbors, topo.Topology):
        graph = neighbors
        neighbors = graph.adjacency
        if w is None:
            w = topo.metropolis_weights(graph)
    if w is None:
        w = np.asarray(neighbors, dtype=np.float64)
    l_bound = _l_bound(problem)
    k = part.num_nodes
    sigma_k = block_spectral_norms(env.a_parts, cache=sigma_k, num_nodes=k)
    beta_ub = float(topo.beta(np.asarray(w)))
    mask = neighbor_mask(neighbors, k, dtype=env.a_parts.dtype,
                         device=env.a_parts.device)
    gap_thresh, grad_thresh = certificate_thresholds(
        part.mask(env.masks.dtype, device=env.masks.device), sigma_k,
        beta_ub, l_bound, eps, k)
    return CertificateRecorder(
        problem=problem, part=part, a_parts=env.a_parts,
        gp_parts=env.gp_parts, masks=env.masks, neigh_mask=mask,
        sigma_k=sigma_k, eps=float(eps), beta_ub=beta_ub, l_bound=l_bound,
        gap_thresh=float(gap_thresh), grad_thresh=float(grad_thresh),
        stop_on_certified=stop_on_certified, cons_tol=cons_tol,
        viol_tol=viol_tol, stop_on_violation=stop_on_violation)


def cohort_certificate_recorder(problem, part: Partition, env, eps: float, *,
                                sigma_k=None, stop_on_certified: bool = True,
                                cons_tol: float = 1e-2, viol_tol: float = 0.1,
                                stop_on_violation: bool = False
                                ) -> CertificateRecorder:
    """The client-sampling certificate (``cohort=True``): Prop. 1 over the
    sampled subnetwork of a COMPLETE base graph, with no (K, K) tensor:
    the neighborhood is structural (the cohort) and the thresholds take
    the sampled-complete contraction factor beta = 0 (the induced mixing
    matrix is a rank-one projector). ``sigma_k``: optional precomputed
    (K,) ``block_spectral_norms`` values."""
    l_bound = _l_bound(problem)
    k = part.num_nodes
    sigma_k = block_spectral_norms(env.a_parts, cache=sigma_k)
    gap_thresh, grad_thresh = certificate_thresholds(
        env.masks, sigma_k, 0.0, l_bound, eps, k)
    return CertificateRecorder(
        problem=problem, part=part, a_parts=env.a_parts,
        gp_parts=env.gp_parts, masks=env.masks, neigh_mask=None,
        sigma_k=sigma_k, eps=float(eps), beta_ub=0.0, l_bound=l_bound,
        gap_thresh=float(gap_thresh), grad_thresh=float(grad_thresh),
        stop_on_certified=stop_on_certified, cons_tol=cons_tol,
        viol_tol=viol_tol, stop_on_violation=stop_on_violation, cohort=True)


def dynamize(recorder):
    """Churn-aware variant: every certificate part reads its Eq.-10
    neighborhood mask and threshold from the per-round schedule (see
    ``certificate_schedule``) instead of the static graph — the static
    graph's denser mixing would make the threshold unsoundly loose in
    rounds where nodes have dropped."""
    if isinstance(recorder, ComposedRecorder):
        return dataclasses.replace(recorder, parts=tuple(
            dynamize(p) for p in recorder.parts))
    if isinstance(recorder, CertificateRecorder):
        return dataclasses.replace(recorder, dynamic=True)
    return recorder


def attackify(recorder, cons_tol: float = 0.25, viol_tol: float = 0.5):
    """Attack-harness variant: every certificate part audits the honest
    cohort from the schedule's ``atk_dishonest`` mask (see
    ``CertificateRecorder.attack_aware``). The drivers apply it when an
    attack corrupts payloads; a clean run's recorder is untouched.

    The tolerances widen: when the attack begins at round S > 0, the
    cohort invariant inherits the boundary offset C = sum_L (K a_L x_L(S)
    - v_L(S)), the liars' pre-onset entanglement with the honest states.
    A sound defense keeps C constant (the residual plateaus near ||C||,
    ~0.1 for onsets in the first tenth of training, 0 for round-0 onsets),
    while an undefended run absorbs new lie mass every round and the
    residual grows toward ~1; the (0.25, 0.5) band separates the two."""
    if isinstance(recorder, ComposedRecorder):
        return dataclasses.replace(recorder, parts=tuple(
            attackify(p, cons_tol, viol_tol) for p in recorder.parts))
    if isinstance(recorder, CertificateRecorder):
        return dataclasses.replace(recorder, attack_aware=True,
                                   cons_tol=max(recorder.cons_tol, cons_tol),
                                   viol_tol=max(recorder.viol_tol, viol_tol))
    return recorder


def first_certificate(recorder) -> CertificateRecorder | None:
    """The first ``CertificateRecorder`` in ``recorder`` (itself or a part
    of a ``ComposedRecorder``), or None."""
    if isinstance(recorder, CertificateRecorder):
        return recorder
    if isinstance(recorder, ComposedRecorder):
        for p in recorder.parts:
            found = first_certificate(p)
            if found is not None:
                return found
    return None


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def certificate_round_inputs(cert: CertificateRecorder, w_t, active
                             ) -> tuple[np.ndarray, float]:
    """(neighbor mask, Eq.-10 threshold) for ONE churn round, on the host:
    the mask is the support of the reweighted W_t (self-inclusive; dropped
    neighbors have W_kj = 0 and leave the neighborhood, as in the real
    exchange), and the threshold re-derives with beta of the ACTIVE
    subnetwork's mixing submatrix (frozen nodes are fixed points of W_t,
    whose eigenvalue-1 blocks say nothing about the survivors'
    contraction)."""
    w_t = np.asarray(w_t, np.float64)
    k = w_t.shape[0]
    mask = (w_t != 0) | np.eye(k, dtype=bool)
    act = np.asarray(active) > 0
    beta_t = topo.beta(w_t[np.ix_(act, act)]) if act.sum() > 1 else 0.0
    n_sizes = np.sum(_host(cert.masks), axis=1)
    scale = float(np.sum(n_sizes ** 2 * _host(cert.sigma_k)))
    thresh = (scale ** -0.5) * (1.0 - beta_t) / (
        2.0 * cert.l_bound * np.sqrt(float(k))) * cert.eps
    return mask, float(thresh)


def certificate_schedule(recorder, w_stack, actives,
                         record_mask: np.ndarray) -> dict:
    """The dynamic certificate's per-round schedule entries, on the host:
    ``cert_mask`` (T, K, K) and ``cert_grad_thresh`` (T,), evaluated for
    the record rounds only (no other round's slice is read)."""
    cert = first_certificate(recorder)
    t, k = np.shape(w_stack)[0], np.shape(w_stack)[1]
    dtype = np.asarray(w_stack[:1]).dtype if t else np.float32
    masks = np.zeros((t, k, k), dtype=dtype)
    thresh = np.zeros((t,), dtype=dtype)
    for t_i in np.nonzero(np.asarray(record_mask, dtype=bool))[0]:
        m, th = certificate_round_inputs(cert, w_stack[t_i], actives[t_i])
        masks[t_i] = m
        thresh[t_i] = th
    return {"cert_mask": masks, "cert_grad_thresh": thresh}


def make_recorder(kind, problem, part: Partition, env, graph, w,
                  eps: float | None, *, sigma_k=None):
    """Resolve a driver's ``recorder=`` argument ("gap", "certificate",
    "gap+certificate", or an already-built Recorder instance). In the
    composed form only the certificate drives the stop. ``sigma_k``: the
    certificate's (K,) spectral norms, computed elsewhere (over ranks,
    where ``env`` is one rank's block)."""
    if not isinstance(kind, str):
        return kind
    if kind == "gap":
        return GapRecorder(problem, part, eps=eps)
    if kind in ("certificate", "gap+certificate"):
        if eps is None:
            raise ValueError(
                f"recorder={kind!r} needs eps=: the Prop.-1 conditions "
                "certify a specific accuracy")
        cert = certificate_recorder(problem, part, env, graph.adjacency,
                                    eps, w=w, sigma_k=sigma_k)
        if kind == "certificate":
            return cert
        return ComposedRecorder((GapRecorder(problem, part, eps=None), cert))
    raise ValueError(f"unknown recorder {kind!r} (want 'gap', 'certificate', "
                     "'gap+certificate' or a Recorder instance)")


def annotate_violation(history: dict) -> dict:
    """``violated_round``: the first recorded round whose
    ``certificate_violated`` flag fired (None when it never fired; absent
    when the recorder has no certificate part)."""
    if "certificate_violated" in history:
        history["violated_round"] = next(
            (r for r, v in zip(history["round"],
                               history["certificate_violated"]) if v > 0),
            None)
    return history


def history_from(recorder, result) -> dict:
    """The driver history dict from a ``BlockRunResult``: one list per
    recorder label, the recorded round indices (truncated at early stop) and
    the stop round (None when the run used its full budget)."""
    history: dict = {"round": [int(t) for t in result.rounds]}
    for j, name in enumerate(recorder.labels):
        history[name] = [float(v) for v in result.metrics[:, j]]
    history["stop_round"] = result.stop_round
    return annotate_violation(history)


def render_footprints(k: int, d: int, n_k: int, itemsize: int = 4) -> str:
    """Human-readable per-record-round collective footprint of the stock
    recorders on K ranks, one node each (the reference's ``dryrun --plan``
    section, line for line)."""
    gap = GapRecorder(problem=None, part=Partition(num_nodes=k, n=k * n_k,
                                                   block=n_k))
    lines = [f"[cola recorder footprint] K={k} d={d} n_k={n_k} "
             f"itemsize={itemsize} (bytes per device per record round)"]
    rows = [("gap (gather)", "dense",
             gap.collective_footprint(k, d, n_k, itemsize)),
            ("certificate", "dense",
             CertificateRecorder.collective_footprint(
                 _FootprintOnly(), k, d, n_k, itemsize, "dense")),
            ("certificate", "ring",
             CertificateRecorder.collective_footprint(
                 _FootprintOnly(), k, d, n_k, itemsize, "ring"))]
    for name, comm, fp in rows:
        body = "  ".join(f"{kind}={fp[kind]:,}" for kind in
                         ("all-gather", "collective-permute", "all-reduce"))
        lines.append(f"  {name:<16} comm={comm:<6} {body}")
    return "\n".join(lines)


class _FootprintOnly:
    """Stand-in self for ``CertificateRecorder.collective_footprint``, so
    the footprint renders without problem tensors."""

    labels = CERT_METRICS
