"""Plain COLA (He, Bian and Jaggi, NeurIPS 2018, Algorithm 1): the
benchmark's reference.

Written from the paper's equations in plain PyTorch and NumPy, in fp32
with TF32 off, and imports nothing of the program under test: it derives
again what the program derives (the column partition, Metropolis weights,
the node-local Gram blocks, sigma_k, the certificate thresholds) from the
data matrix X, the labels y and the cell's settings.

A round, on all K nodes at once (state x (K, n_k), v (K, d)):

    v_half = W v                      gossip through the mixing matrix
    g      = grad f(v_half)
    dx     = kappa * n_k cyclic coordinate steps on G_k (Eq. 1-2)
    x     += gamma dx
    v      = v_half + gamma K A_[k] dx

The local solve has two forms, equal in exact arithmetic:

* ``cd_gram``: the coordinate loop over the Gram block G_k, in NumPy on the
  host (n_k is small where it runs: the lasso's 125 features a node);
* ``cd_linear_block``: one pass of coordinates under a LINEAR prox (the
  ridge dual's g_j(w) = w^2/2 + y_j w) is a forward substitution
  (I + s tril(A^T A)) dx = -(x + lin + A^T grad), solved here chunk by
  chunk with the part of the residual r = A dx that earlier chunks made.
  A plain loop over 25,000 coordinates a node takes seconds a round on the
  card; this takes milliseconds and is the same recurrence.

``precision="tf32"`` rounds both operands of every matrix product to TF32
(10 mantissa bits, round to nearest even) and accumulates in fp32: the
control that the comparison has to reject.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

GAP_COLS = ("primal", "hamiltonian", "dual", "gap", "consensus_violation")
CERT_COLS = ("local_gap_max", "grad_disagreement_max", "cond9_nodes",
             "cond10_nodes", "certified", "consensus_residual",
             "certificate_violated")
# Prop. 1 also asks the Lemma-1 invariant residual to stay below this to
# certify (the stated default of the paper's tamper check)
CONS_TOL = 1e-2
VIOL_TOL = 0.1
# sigma_k = ||A_[k]||^2 by power iteration from a seeded normal start
POWER_ITERS = 50
POWER_SEED = 0


# ---------------------------------------------------------------------------
# graph and mixing
# ---------------------------------------------------------------------------

def ring_adjacency(k: int) -> np.ndarray:
    adj = np.zeros((k, k), dtype=bool)
    for i in range(k):
        adj[i, (i + 1) % k] = adj[(i + 1) % k, i] = True
    return adj


GRAPHS = {"ring": ring_adjacency}


def metropolis(adj: np.ndarray) -> np.ndarray:
    """W_ij = 1 / (1 + max(deg_i, deg_j)) on edges, the rest on the
    diagonal (App. B): symmetric and doubly stochastic."""
    k = adj.shape[0]
    deg = adj.sum(axis=1)
    w = np.zeros((k, k), dtype=np.float64)
    for i in range(k):
        for j in range(k):
            if adj[i, j]:
                w[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        w[i, i] = 1.0 - w[i].sum()
    return w


def beta(w: np.ndarray) -> float:
    """Second largest eigenvalue magnitude of the symmetric W."""
    eig = np.sort(np.abs(np.linalg.eigvalsh(w)))[::-1]
    return float(eig[1]) if eig.size > 1 else 0.0


# ---------------------------------------------------------------------------
# precision
# ---------------------------------------------------------------------------

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32's 10 mantissa bits (nearest, ties to
    even), kept in fp32."""
    b = t.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


class Products:
    """Matrix products of one precision. ``hold`` keeps a large operand
    that is used every round, rounded once where the precision asks."""

    def __init__(self, precision: str):
        if precision not in ("fp32", "tf32"):
            raise ValueError(f"precision {precision!r}: want fp32 or tf32")
        self.tf32 = precision == "tf32"

    def hold(self, t: torch.Tensor) -> torch.Tensor:
        return tf32_round(t) if self.tf32 else t

    def mm(self, a, b, held: str = "") -> torch.Tensor:
        """a @ b (batched where 3-d); ``held`` names the operands already
        passed through ``hold``."""
        if self.tf32:
            a = a if "a" in held else tf32_round(a)
            b = b if "b" in held else tf32_round(b)
        return torch.matmul(a, b)


# ---------------------------------------------------------------------------
# problems
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Glm:
    """f(Ax) + sum_i g_i(x_i) with A (d, n), its conjugates and the prox
    constants (l1, l2, box) of prox(z) = clip(soft(z - s*p_i, s*l1) /
    (1 + s*l2), +-box)."""

    kind: str
    lam: float
    box: float
    tau: float
    l1: float
    l2: float
    l_bound: float

    def f(self, v, b):
        if self.kind == "lasso":
            return 0.5 * torch.sum((v - b) ** 2, dim=-1)
        return torch.sum(v ** 2, dim=-1) / (2.0 * self.lam)

    def grad_f(self, v, b):
        return v - b if self.kind == "lasso" else v / self.lam

    def f_conj(self, w, b):
        if self.kind == "lasso":
            return 0.5 * torch.sum(w ** 2, dim=-1) + torch.sum(w * b, dim=-1)
        return 0.5 * self.lam * torch.sum(w ** 2, dim=-1)

    def g_el(self, x, p):
        if self.kind == "lasso":
            return self.lam * torch.abs(x) + torch.where(
                torch.abs(x) <= self.box, 0.0, math.inf)
        return 0.5 * x ** 2 + p * x

    def g_conj_el(self, u, p):
        if self.kind == "lasso":
            return self.box * torch.clamp(torch.abs(u) - self.lam, min=0.0)
        return 0.5 * (u - p) ** 2


def make_glm(kind: str, lam: float, box: float = math.inf) -> Glm:
    """Lasso over features (A = X, f = ||v - y||^2 / 2, g = lam |x| with
    |x| <= box) or ridge regression through its dual over samples
    (A = X^T, f = ||u||^2 / (2 lam), g_j(w) = w^2 / 2 + y_j w)."""
    if kind == "lasso":
        return Glm(kind, lam, box, tau=1.0, l1=lam, l2=0.0, l_bound=box)
    if kind == "ridge_dual":
        return Glm(kind, lam, math.inf, tau=lam, l1=0.0, l2=1.0,
                   l_bound=math.inf)
    raise ValueError(f"unknown problem {kind!r}")


# ---------------------------------------------------------------------------
# local solvers
# ---------------------------------------------------------------------------

def cd_gram(gram: np.ndarray, x: np.ndarray, atg: np.ndarray,
            lin: np.ndarray, mask: np.ndarray, steps: int, sot: float,
            l1: float, l2: float, box: float) -> np.ndarray:
    """``steps`` cyclic coordinate updates of every node's G_k, carrying
    h = G dx; NumPy fp32 on the host. gram (K, n_k, n_k); the rest
    (K, n_k). Returns dx (K, n_k)."""
    f32 = np.float32
    k, n_k, _ = gram.shape
    sot, l1, l2, box = f32(sot), f32(l1), f32(l2), f32(box)
    q = sot * np.einsum("kii->ki", gram)
    dx = np.zeros_like(x)
    h = np.zeros_like(x)
    one, zero = f32(1.0), f32(0.0)
    for t in range(steps):
        i = t % n_k
        z = x[:, i] + dx[:, i]
        g = atg[:, i] + sot * h[:, i]
        qi = q[:, i]
        ok = (qi > 0) & (mask[:, i] > 0)
        s = one / np.where(qi > 0, qi, one)
        u = z - g * s - s * lin[:, i]
        soft = np.sign(u) * np.maximum(np.abs(u) - s * l1, zero)
        z_new = np.clip(soft / (one + s * l2), -box, box)
        delta = np.where(ok, z_new - z, zero).astype(f32)
        dx[:, i] += delta
        h += gram[:, :, i] * delta[:, None]
    return dx


def cd_loop(rows: torch.Tensor, x, grads, lin, mask, steps: int, sot: float,
            l1: float, l2: float, box: float) -> torch.Tensor:
    """``steps`` cyclic coordinate updates carrying r = A_[k] dx; rows
    (K, n_k, d) holds the columns A_i. Any prox; slow (a few operations a
    coordinate), so the tests use it to hold ``cd_linear_block``."""
    k, n_k, d = rows.shape
    q = sot * torch.sum(rows * rows, dim=-1)
    dx = torch.zeros_like(x)
    r = torch.zeros_like(grads)
    for t in range(steps):
        i = t % n_k
        a_i = rows[:, i, :]
        z = x[:, i] + dx[:, i]
        g = torch.sum(a_i * (grads + sot * r), dim=-1)
        qi = q[:, i]
        ok = (qi > 0) & (mask[:, i] > 0)
        s = 1.0 / torch.where(qi > 0, qi, torch.ones_like(qi))
        u = z - g * s - s * lin[:, i]
        soft = torch.sign(u) * torch.clamp(torch.abs(u) - s * l1, min=0.0)
        z_new = torch.clamp(soft / (1.0 + s * l2), -box, box)
        delta = torch.where(ok, z_new - z, torch.zeros_like(z))
        dx[:, i] += delta
        r += a_i * delta[:, None]
    return dx


def cd_linear_block(mm: Products, rows: torch.Tensor, x, grads, lin, mask,
                    sot: float, l2: float, chunk: int = 256,
                    held: str = "") -> torch.Tensor:
    """One pass of cyclic coordinate updates under the linear prox
    (l1 = 0, no box), as a blocked forward substitution. With
    q_i = sot ||A_i||^2 and r the residual A dx of the coordinates before
    i, coordinate i moves by

        delta_i = -(l2 x_i + lin_i + A_i.(grad + sot r)) / (q_i + l2),

    i.e. (l2 I + sot tril(A^T A)) delta = -(l2 x + lin + A^T grad) over the
    pass. Rows of masked or zero columns get delta 0, as in the loop.
    ``held="ab"``: ``rows`` went through ``mm.hold``."""
    k, n_k, d = rows.shape
    dx = torch.empty_like(x)
    r = torch.zeros_like(grads)
    for c0 in range(0, n_k, chunk):
        c1 = min(n_k, c0 + chunk)
        a_c = rows[:, c0:c1, :]                                  # (K, B, d)
        gc = mm.mm(a_c, a_c.transpose(1, 2), held=held)          # (K, B, B)
        diag = torch.diagonal(gc, dim1=1, dim2=2)
        ok = (diag > 0) & (mask[:, c0:c1] > 0)
        proj = mm.mm(a_c, (grads + sot * r)[..., None],
                     held=held[:1])[..., 0]                      # (K, B)
        rhs = -(l2 * x[:, c0:c1] + lin[:, c0:c1] + proj)
        m = sot * torch.tril(gc)
        m = m + l2 * torch.eye(c1 - c0, dtype=m.dtype, device=m.device)
        # a coordinate that makes no update: its row is the identity
        m = torch.where(ok[:, :, None], m,
                        torch.eye(c1 - c0, dtype=m.dtype, device=m.device))
        rhs = torch.where(ok, rhs, torch.zeros_like(rhs))
        delta = torch.linalg.solve_triangular(m, rhs[..., None],
                                              upper=False)[..., 0]
        dx[:, c0:c1] = delta
        r = r + mm.mm(a_c.transpose(1, 2), delta[..., None],
                      held=held[:1])[..., 0]
    return dx


# ---------------------------------------------------------------------------
# the solve
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RefResult:
    history: dict          # "round" and one list per recorded column
    stop_round: int | None
    x_parts: torch.Tensor  # (K, n_k) at the stop round (or the last)
    v_stack: torch.Tensor  # (K, d)


def _rows(glm: Glm, x_data: torch.Tensor, k: int, n_k: int) -> torch.Tensor:
    """(K, n_k, d): row i of node k's block is column A_i of A. For the
    ridge dual these are X's sample rows themselves (a view)."""
    if glm.kind == "lasso":
        n_pad = k * n_k - x_data.shape[1]
        a = torch.nn.functional.pad(x_data, (0, n_pad)) if n_pad else x_data
        return a.reshape(a.shape[0], k, n_k).permute(1, 2, 0).contiguous()
    n_pad = k * n_k - x_data.shape[0]
    a = torch.nn.functional.pad(x_data, (0, 0, 0, n_pad)) if n_pad \
        else x_data
    return a.reshape(k, n_k, x_data.shape[1])


def _sigma(mm: Products, rows: torch.Tensor) -> torch.Tensor:
    """sigma_k = ||A_[k]||_2^2 (Eq. 7) by power iteration on A^T A from a
    seeded normal start (``POWER_SEED``, ``POWER_ITERS`` steps)."""
    k, n_k, _ = rows.shape
    gen = torch.Generator(device=rows.device).manual_seed(POWER_SEED)
    v = torch.randn((k, n_k, 1), generator=gen, dtype=rows.dtype,
                    device=rows.device)
    rt = rows.transpose(1, 2)

    def ata(u):
        return mm.mm(rows, mm.mm(rt, u, held="a"), held="a")

    for _ in range(POWER_ITERS):
        w = ata(v)
        v = w / (torch.linalg.vector_norm(w, dim=1, keepdim=True) + 1e-30)
    num = torch.sum(ata(v) * v, dim=(1, 2))
    return num / (torch.sum(v * v, dim=(1, 2)) + 1e-30)


def solve(kind: str, x_data: torch.Tensor, y: torch.Tensor, *, lam: float,
          box: float = math.inf, nodes: int, graph: str = "ring",
          kappa: float = 1.0, recorder: str, record_every: int,
          eps: float, max_rounds: int, precision: str = "fp32",
          chunk: int = 256) -> RefResult:
    """Run COLA from x = 0, v = 0 until the recorder's stop fires at a
    record round (every ``record_every``-th round and the last): the
    certificate of Prop. 1 for ``"gap+certificate"`` (the gap row is
    recorded beside it), gap <= eps for ``"gap"``."""
    if recorder not in ("gap", "gap+certificate"):
        raise ValueError(f"recorder {recorder!r}: want gap or "
                         "gap+certificate")
    mm = Products(precision)
    glm = make_glm(kind, lam, box)
    dev, f32 = x_data.device, torch.float32
    k = nodes
    b = y if kind == "lasso" else None                 # f's data term
    n = x_data.shape[1] if kind == "lasso" else x_data.shape[0]
    n_k = -(-n // k)
    gp = torch.zeros(k * n_k, dtype=f32, device=dev)
    if kind == "ridge_dual":
        gp[:n] = y
    gp = gp.reshape(k, n_k)
    mask = (torch.arange(k * n_k, device=dev) < n).to(f32).reshape(k, n_k)
    rows = mm.hold(_rows(glm, x_data, k, n_k))         # (K, n_k, d)
    rows_t = rows.transpose(1, 2)                      # (K, d, n_k)
    d = rows.shape[2]
    adj = GRAPHS[graph](k)
    w64 = metropolis(adj)
    w = torch.tensor(w64, dtype=f32, device=dev)
    gamma = 1.0
    sot = gamma * k / glm.tau
    steps = max(1, int(round(kappa * n_k)))
    gram = None
    if glm.l1 != 0.0 or math.isfinite(glm.box):
        gram_t = mm.mm(rows, rows_t, held="ab")
        gram = gram_t.cpu().numpy()
        mask_np = mask.cpu().numpy()
        gp_np = gp.cpu().numpy()
    elif steps != n_k:
        raise ValueError("cd_linear_block runs one pass of coordinates: "
                         f"kappa * n_k = {steps} != n_k = {n_k}")

    cert = recorder == "gap+certificate"
    if cert:
        if not math.isfinite(glm.l_bound):
            raise ValueError("the certificate needs an L-bounded g")
        sigma = _sigma(mm, rows)
        n_sizes = mask.sum(dim=1)
        scale = torch.sum(n_sizes ** 2 * sigma)
        gap_thresh = eps / (2.0 * k)
        grad_thresh = float((scale ** -0.5) * (1.0 - beta(w64))
                            / (2.0 * glm.l_bound * math.sqrt(k)) * eps)
        neigh = torch.tensor((adj | np.eye(k, dtype=bool)).astype(np.float32),
                             device=dev)
    cols = GAP_COLS + (CERT_COLS if cert else ())
    history = {"round": [], **{c: [] for c in cols}}

    def ax_of(x_parts):
        return torch.sum(mm.mm(rows_t, x_parts[..., None], held="a")[..., 0],
                         dim=0)                        # (d,)

    def row_of(x_parts, v):
        ax = ax_of(x_parts)
        x_flat = x_parts.reshape(-1)
        gpf, mf = gp.reshape(-1), mask.reshape(-1)
        wk = glm.grad_f(v, b)                          # (K, d)
        w_bar = wk.mean(dim=0)
        atw = mm.mm(rows, w_bar.expand(k, d)[..., None],
                    held="a")[..., 0].reshape(-1)
        g_val = torch.sum(glm.g_el(x_flat, gpf) * mf)
        gc_val = torch.sum(glm.g_conj_el(-atw, gpf) * mf)
        h_a = torch.mean(glm.f(v, b)) + g_val
        h_b = torch.mean(glm.f_conj(wk, b)) + gc_val
        out = [glm.f(ax, b) + g_val, h_a, -h_b, h_a + h_b,
               torch.sum((v - ax[None, :]) ** 2)]
        if cert:
            atg = mm.mm(rows, wk[..., None], held="a")[..., 0]
            conj = glm.g_conj_el(-atg, gp)
            prim = glm.g_el(x_parts, gp)
            local_gap = torch.sum(v * wk, dim=1) + torch.sum(
                (prim + conj) * mask, dim=1)
            nmean = (neigh @ wk) / neigh.sum(dim=1, keepdim=True)
            disagree = torch.linalg.vector_norm(wk - nmean, dim=1)
            resid = torch.linalg.vector_norm(v.sum(dim=0) / k - ax) / (
                torch.linalg.vector_norm(ax) + 1.0)
            c9 = local_gap <= gap_thresh
            c10 = disagree <= grad_thresh
            certified = bool((c9 & c10).all()) and float(resid) <= CONS_TOL
            out += [local_gap.max(), disagree.max(), c9.sum(), c10.sum(),
                    float(certified), resid,
                    float(not (float(resid) <= VIOL_TOL))]
        return [float(t) for t in out]

    x_parts = torch.zeros((k, n_k), dtype=f32, device=dev)
    v = torch.zeros((k, d), dtype=f32, device=dev)
    stop_round = None
    for t in range(max_rounds):
        v_half = mm.mm(w, v)
        grads = glm.grad_f(v_half, b)
        if gram is not None:
            atg = mm.mm(rows, grads[..., None], held="a")[..., 0]
            dx = torch.from_numpy(cd_gram(
                gram, x_parts.cpu().numpy(), atg.cpu().numpy(), gp_np,
                mask_np, steps, sot, glm.l1, glm.l2, glm.box)).to(dev)
        else:
            dx = cd_linear_block(mm, rows, x_parts, grads, gp, mask, sot,
                                 glm.l2, chunk=chunk, held="ab")
        x_parts = x_parts + gamma * dx
        dv = mm.mm(rows_t, dx[..., None], held="a")[..., 0]
        v = v_half + gamma * k * dv
        if t % record_every == 0 or t == max_rounds - 1:
            row = row_of(x_parts, v)
            history["round"].append(t)
            for c, val in zip(cols, row):
                history[c].append(val)
            done = (row[cols.index("certified")] > 0) if cert \
                else row[cols.index("gap")] <= eps
            if done:
                stop_round = t
                break
    return RefResult(history=history, stop_round=stop_round,
                     x_parts=x_parts, v_stack=v)
