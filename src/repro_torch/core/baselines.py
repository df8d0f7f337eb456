"""Decentralized baselines the paper compares against (§4, Fig. 2):

* DGD    — decentralized (sub)gradient descent [Nedic & Ozdaglar 2009],
           prox-variant for composite objectives.
* DIGing — gradient tracking [Nedic et al. 2017]; recovers EXTRA on static
           symmetric W.
* D-ADMM — decentralized consensus ADMM [Shi et al. 2014, Boyd et al. 2011]
           with an inexact local solver (a fixed number of prox-gradient
           steps).

All of them address the sum-structured form  min_w sum_k F_k(w)  with
F_k(w) = f(X_k w; y_k) + (1/K) g(w): the data is partitioned by SAMPLES
(rows), each node holds a full copy of w — in contrast to CoLA's column
partitioning.

Their rounds are dense mixing ``W @ ws`` and the products ``X_k w`` and
``X_k^T r`` (``torch.bmm``), as the reference leaves them to XLA: no CUDA
kernel of this package runs here. The runners execute on the round-block
engine (``repro_torch.core.executor``) by default, with ``executor="loop"``
kept as the per-round path; both give bitwise the same results.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import executor as exec_engine, metrics as metrics_lib, \
    topology as topo
from repro_torch.device import resolve


@dataclasses.dataclass(frozen=True)
class ConsensusProblem:
    """min_w sum_k [ loss(X_k w, y_k) + (1/K) g(w) ], nodes hold row blocks."""

    x_parts: torch.Tensor   # (K, m_k, d) row blocks (padded with zero rows)
    y_parts: torch.Tensor   # (K, m_k)
    row_mask: torch.Tensor  # (K, m_k)
    loss: str               # "square" | "logistic"
    reg: str                # "l2" | "l1"
    lam: float

    @property
    def num_nodes(self) -> int:
        return self.x_parts.shape[0]

    @property
    def dim(self) -> int:
        return self.x_parts.shape[2]

    def _fit(self, z, y, mask) -> torch.Tensor:
        if self.loss == "square":
            return 0.5 * torch.sum(((z - y) ** 2) * mask)
        return torch.sum(torch.logaddexp(torch.zeros_like(z), -y * z) * mask)

    # -- smooth part: data fit + (l2 reg if reg == l2) ----------------------
    def local_fit(self, w: torch.Tensor, k_slice) -> torch.Tensor:
        """Node k's data fit at w; ``k_slice`` = (X_k, y_k, mask_k)."""
        xk, yk, mk = k_slice
        return self._fit(xk @ w, yk, mk)

    def objective(self, w: torch.Tensor) -> torch.Tensor:
        """Global F(w) (one shared w)."""
        fit = self._fit(self.x_parts @ w, self.y_parts, self.row_mask)
        if self.reg == "l2":
            return fit + 0.5 * self.lam * torch.sum(w ** 2)
        return fit + self.lam * torch.sum(torch.abs(w))

    def smooth_grad(self, w_stack: torch.Tensor) -> torch.Tensor:
        """(K, d) gradients of the smooth part of each F_k at each node's
        w_k: two reads of X, ``X_k w_k`` then ``X_k^T r_k``."""
        z = torch.bmm(self.x_parts, w_stack.unsqueeze(-1)).squeeze(-1)
        if self.loss == "square":
            resid = (z - self.y_parts) * self.row_mask
        else:
            resid = (-self.y_parts * torch.sigmoid(-self.y_parts * z)
                     * self.row_mask)
        grad = torch.bmm(resid.unsqueeze(1), self.x_parts).squeeze(1)
        if self.reg == "l2":
            grad = grad + (self.lam / self.num_nodes) * w_stack
        return grad

    def prox_reg(self, w: torch.Tensor, step) -> torch.Tensor:
        """prox of (step/K) * the nonsmooth regularizer (only l1 is)."""
        if self.reg == "l1":
            t = step * self.lam / self.num_nodes
            return torch.sign(w) * torch.clamp(torch.abs(w) - t, min=0.0)
        return w


def make_consensus_problem(x, y, k: int, *, loss: str, reg: str, lam: float,
                           device=None) -> ConsensusProblem:
    """Split (m, d) data by rows over K nodes, zero-padding the last block.

    ``x`` and ``y`` are numpy arrays, or tensors already on ``device``
    (default "cuda"): a tensor never leaves its device, and when K divides
    m the row blocks are a view of ``x`` (no copy of the matrix)."""
    dev = resolve(device)
    for name, t in (("x", x), ("y", y)):
        if torch.is_tensor(t) and t.device != dev:
            raise ValueError(f"make_consensus_problem: {name} is on "
                             f"{t.device}, the problem was asked for on {dev}")
    x = torch.as_tensor(x, device=dev)
    y = torch.as_tensor(y, device=dev)
    m, d = x.shape
    m_k = -(-m // k)
    pad = k * m_k - m
    if pad:
        x = torch.cat([x, x.new_zeros((pad, d))])
        y = torch.cat([y, y.new_zeros((pad,))])
    mask = (torch.arange(k * m_k, device=dev) < m).to(x.dtype)
    return ConsensusProblem(x.reshape(k, m_k, d), y.reshape(k, m_k),
                            mask.reshape(k, m_k), loss, reg, lam)


class BaselineResult(NamedTuple):
    w_stack: torch.Tensor
    history: dict


def _check_unported(robust, telemetry) -> None:
    for bad, what, item in (
            (robust is not None, f"robust={robust!r}",
             "11 (attacks and robust mixing)"),
            (telemetry, "telemetry=True", "15 (observability)")):
        if bad:
            raise NotImplementedError(
                f"repro_torch baselines: {what} is not ported yet "
                f"(ROADMAP queue 1 item {item})")


def _on_device(prob: ConsensusProblem, device) -> None:
    dev = resolve(device)
    if prob.x_parts.device != dev:
        raise ValueError(f"problem data is on {prob.x_parts.device}, the "
                         f"baseline was asked to run on {dev}")


def _mixing(prob: ConsensusProblem, graph: topo.Topology) -> torch.Tensor:
    return torch.as_tensor(topo.metropolis_weights(graph),
                           dtype=prob.x_parts.dtype,
                           device=prob.x_parts.device)


def _run(prob: ConsensusProblem, round_fn: Callable, state, rounds: int,
         record_every: int, executor: str = "block",
         block_size: int = 64) -> BaselineResult:
    """Drive ``round_fn`` (``carry -> carry``, the node iterates first in
    the carry) for ``rounds`` rounds, recording the objective at the
    nodes' mean and the consensus error."""
    def row(carry):
        ws = carry[0]
        mean = torch.mean(ws, dim=0)
        return torch.stack([prob.objective(mean),
                            torch.sum((ws - mean) ** 2)])

    recorder = metrics_lib.FnRecorder(labels=("objective", "consensus"),
                                      fn=row)
    if executor == "block":
        res = exec_engine.run_round_blocks(
            lambda carry, _ctx, _sched: round_fn(carry), state, {},
            recorder=recorder,
            record_mask=exec_engine.record_flags(rounds, record_every),
            block_size=block_size, num_rounds=rounds)
        return BaselineResult(w_stack=res.state[0],
                              history=metrics_lib.history_from(recorder, res))
    if executor != "loop":
        raise ValueError(f"unknown executor {executor!r} "
                         "(want 'block' or 'loop')")
    history: dict = {"round": [], "objective": [], "consensus": [],
                     "stop_round": None}
    for t in range(rounds):
        state = round_fn(state)
        if t % record_every == 0 or t == rounds - 1:
            history["round"].append(t)
            for name, val in zip(recorder.labels,
                                 row(state).to(torch.float32).cpu().tolist()):
                history[name].append(val)
    return BaselineResult(w_stack=state[0], history=history)


# ---------------------------------------------------------------------------
# DGD (prox-variant for composite objectives)
# ---------------------------------------------------------------------------

def dgd_round(prob: ConsensusProblem, graph: topo.Topology, *, step: float,
              diminishing: bool = False) -> tuple[Callable, tuple]:
    """DGD's round ``(ws, t) -> (ws, t)`` and its initial carry:
    ws <- prox(W ws - alpha grad(ws), alpha), alpha = step or
    step / sqrt(t + 1). One gradient (two reads of X) per round."""
    w_mix = _mixing(prob, graph)
    k, d = prob.num_nodes, prob.dim

    def one_round(carry):
        ws, t = carry
        alpha = step / torch.sqrt(t + 1.0) if diminishing else step
        new = prob.prox_reg(w_mix @ ws - alpha * prob.smooth_grad(ws), alpha)
        return (new, t + 1.0)

    zeros = prob.x_parts.new_zeros
    return one_round, (zeros((k, d)), zeros(()))


def run_dgd(prob: ConsensusProblem, graph: topo.Topology, *, step: float,
            rounds: int, record_every: int = 1, diminishing: bool = False,
            robust: str | None = None, executor: str = "block",
            block_size: int = 64, telemetry: bool = False,
            device=None) -> BaselineResult:
    _check_unported(robust, telemetry)
    _on_device(prob, device)
    return _run(prob, *dgd_round(prob, graph, step=step,
                                 diminishing=diminishing),
                rounds, record_every, executor, block_size)


# ---------------------------------------------------------------------------
# DIGing (gradient tracking; == EXTRA on static symmetric W)
# ---------------------------------------------------------------------------

def _tracked_grad(prob: ConsensusProblem, ws):
    """Smooth gradient plus the l1 subgradient (DIGing tracks both)."""
    g = prob.smooth_grad(ws)
    if prob.reg == "l1":
        g = g + (prob.lam / prob.num_nodes) * torch.sign(ws)
    return g


def diging_round(prob: ConsensusProblem, graph: topo.Topology, *,
                 step: float) -> tuple[Callable, tuple]:
    """DIGing's round ``(ws, s, g_prev) -> ...`` and its initial carry:
    ws <- W ws - step s; s <- W s + g(ws) - g_prev. One gradient per
    round."""
    w_mix = _mixing(prob, graph)

    def one_round(carry):
        ws, s, g_prev = carry
        ws_new = w_mix @ ws - step * s
        g_new = _tracked_grad(prob, ws_new)
        return (ws_new, w_mix @ s + g_new - g_prev, g_new)

    ws0 = prob.x_parts.new_zeros((prob.num_nodes, prob.dim))
    g0 = _tracked_grad(prob, ws0)
    return one_round, (ws0, g0, g0.clone())


def run_diging(prob: ConsensusProblem, graph: topo.Topology, *, step: float,
               rounds: int, record_every: int = 1,
               robust: str | None = None, executor: str = "block",
               block_size: int = 64, telemetry: bool = False,
               device=None) -> BaselineResult:
    _check_unported(robust, telemetry)
    _on_device(prob, device)
    return _run(prob, *diging_round(prob, graph, step=step), rounds,
                record_every, executor, block_size)


# ---------------------------------------------------------------------------
# Decentralized (consensus) ADMM with inexact local solves
# ---------------------------------------------------------------------------

def dadmm_round(prob: ConsensusProblem, graph: topo.Topology, *, rho: float,
                inner_steps: int = 10, inner_lr: float | None = None
                ) -> tuple[Callable, tuple]:
    """D-ADMM's round ``(xs, a) -> (xs, a)`` and its initial carry.
    ``inner_steps`` prox-gradient steps per round, one gradient (two reads
    of X) each. ``inner_lr`` defaults to the reference's rule,
    1 / (max_k ||X_k||_F^2 + 2 rho max_k deg_k + 1e-9)."""
    dtype, dev = prob.x_parts.dtype, prob.x_parts.device
    adj = torch.as_tensor(graph.adjacency, dtype=dtype, device=dev)
    deg = torch.sum(adj, dim=1)                                  # (K,)
    if inner_lr is None:
        # ||X_k||_F^2 without a squared copy of X
        col_norm = float(torch.max(torch.linalg.vector_norm(
            prob.x_parts, dim=(1, 2)) ** 2))
        inner_lr = 1.0 / (col_norm + rho * float(torch.max(deg)) * 2.0
                          + 1e-9)

    def one_round(carry):
        xs, a = carry
        mid = 0.5 * (deg[:, None] * xs + adj @ xs)     # rho-term anchor
        x_cur = xs
        for _ in range(inner_steps):
            grad = prob.smooth_grad(x_cur) + a + 2.0 * rho * (
                deg[:, None] * x_cur - mid)
            x_cur = prob.prox_reg(x_cur - inner_lr * grad, inner_lr)
        return (x_cur, a + rho * (deg[:, None] * x_cur - adj @ x_cur))

    xs0 = prob.x_parts.new_zeros((prob.num_nodes, prob.dim))
    return one_round, (xs0, torch.zeros_like(xs0))


def run_dadmm(prob: ConsensusProblem, graph: topo.Topology, *, rho: float,
              rounds: int, inner_steps: int = 10,
              inner_lr: float | None = None, record_every: int = 1,
              executor: str = "block", block_size: int = 64,
              telemetry: bool = False, device=None) -> BaselineResult:
    """Consensus ADMM [Shi et al. 2014]:

      x_k^{t+1} = argmin F_k(x) + <a_k^t, x> + rho * d_k ||x - m_k^t||^2
      a_k^{t+1} = a_k^t + rho * (d_k x_k^{t+1} - sum_{j in N_k} x_j^{t+1})

    with m_k^t the average of x_k and its neighbors' midpoints, the argmin
    solved inexactly by ``inner_steps`` prox-gradient steps."""
    _check_unported(None, telemetry)
    _on_device(prob, device)
    return _run(prob, *dadmm_round(prob, graph, rho=rho,
                                   inner_steps=inner_steps,
                                   inner_lr=inner_lr),
                rounds, record_every, executor, block_size)
