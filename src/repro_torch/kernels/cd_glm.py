"""The CoLA local-subproblem CD solver: Hopper kernels, their wrappers and
their plain PyTorch versions.

Two formulations of the same recurrence (see ``repro_torch.core.subproblem``
for the math and the cost model):

* residual — ``cd_solve_blocks``: carries r = A_[k] dx (d,); each step an
  O(d) column dot and an O(d) rank-1 update. Kernel ``cd_residual_kernel``
  in ``csrc/cd_glm.cu`` (replaces the TPU kernel
  ``src/repro/kernels/cd_glm.py::_cd_kernel``).
* Gram-cached — ``cd_solve_blocks_gram``: carries h = G dx (n_k,) over the
  node's Gram block; each step one O(n_k) column axpy. Kernel
  ``cd_gram_kernel`` (replaces ``_cd_kernel_gram``).

The residual wrapper takes A as contiguous rows A_i, layout ``(K, n_k, d)``
(``ColaEnv.a_cols``), so every step reads one contiguous row instead of a
stride-n_k gather out of the reference's ``(K, d, n_k)`` blocks. The Gram
wrapper likewise gives its kernel G's columns as contiguous rows
(``gram_columns``, ``ColaEnv.gram_cols``), since each step reads column i.

Both take an optional ``(K,)`` int32 step budget: a step t >= budget[k]
makes no update (heterogeneous Theta_k). Without budgets the result is the
TPU kernel's.

A wrapper given CPU tensors runs the plain version next to it; given CUDA
tensors it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches (never plain-version calls).
"""
from __future__ import annotations

import ctypes

import torch

LAUNCHES = {"cd_residual": 0, "cd_gram": 0}

# Dynamic shared memory a block may ask for: the 232,448 B opt-in limit of
# Hopper less room for the kernels' static shared memory.
SMEM_OPT_IN = 232_448
SMEM_DYNAMIC_MAX = SMEM_OPT_IN - 1024
# threads per node's block of the residual kernel (one block per node),
# chosen by measurement: chip_smoke.py's ``cd_residual_threads`` row times
# 64, 128 and 256
RESIDUAL_THREADS = 128


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def residual_layout(d: int, threads: int = RESIDUAL_THREADS) -> dict:
    """Where the residual kernel keeps its state at this d and thread
    count, as its launcher in ``csrc/cd_glm.cu`` decides (so this asks the
    built library; card machines only): r and grad in registers (``rpt``
    per thread), in shared memory (``r_smem``) or r in global scratch
    (``scratch``); rows through a ring of ``stages`` rows (4-8), or from
    global memory (``stages`` = 0)."""
    from repro_torch.kernels import build
    out = (ctypes.c_int * 4)()
    if build.load("cd_glm").cd_residual_layout(d, threads, out) != 0:
        raise ValueError(f"residual kernel: threads must be a multiple of 32 "
                         f"in [32, 1024] and d >= 1, got threads={threads}, "
                         f"d={d}")
    return {"threads": threads, "rpt": out[0], "r_smem": bool(out[1]),
            "scratch": bool(out[3]), "stages": out[2]}


# The Gram kernel holds n_k / 32 coordinates per lane in registers, at most
# 48 (``kGramMaxRpt`` in csrc/cd_glm.cu): n_k <= 1,536, above the 1,448
# where ``subproblem.gram_pays`` stops picking it in fp32.
GRAM_MAX_NK = 1536


def gram_ld(n_k: int) -> int:
    """Row stride of the Gram kernel's column layout: n_k rounded up to 4
    floats, so that every row starts 16-byte aligned."""
    return -(-n_k // 4) * 4


def gram_columns(gram_parts: torch.Tensor) -> torch.Tensor:
    """(K, n_k, n_k) Gram blocks -> (K, n_k, ld) contiguous, row i holding
    column i of G (zero padded to ``gram_ld``): the Gram kernel's layout.
    The kernel reads columns, as the Pallas kernel does; it does not rely
    on G being symmetric."""
    k, n_k, _ = gram_parts.shape
    out = gram_parts.new_zeros((k, n_k, gram_ld(n_k)))
    out[:, :, :n_k] = gram_parts.transpose(1, 2)
    return out


def gram_smem_bytes(n_k: int, itemsize: int = 4) -> int:
    """Shared memory of the Gram kernel with G resident: 8 per-coordinate
    constants and G at row stride ``gram_ld(n_k)``."""
    return (8 * n_k + n_k * gram_ld(n_k)) * itemsize


def gram_fits_smem(n_k: int, itemsize: int = 4) -> bool:
    """Whether the Gram kernel keeps G resident in shared memory (n_k <=
    236 in fp32) or streams its columns through a ring."""
    return gram_smem_bytes(n_k, itemsize) <= SMEM_DYNAMIC_MAX


# ---------------------------------------------------------------------------
# plain PyTorch versions (vectorised over K, a Python loop over steps)
# ---------------------------------------------------------------------------

def _prox_delta(z, g, q, lin, mask, live, l1, l2, box):
    q_safe = torch.where(q > 0, q, torch.ones_like(q))
    step = 1.0 / q_safe
    u = z - g * step - step * lin
    soft = torch.sign(u) * torch.clamp(torch.abs(u) - step * l1, min=0.0)
    z_new = torch.clamp(soft / (1.0 + step * l2), -box, box)
    ok = (q > 0) & (mask > 0) & live
    return torch.where(ok, z_new - z, torch.zeros_like(z))


def _live_range(num_steps: int, budgets) -> int:
    """Steps after every node's budget change nothing: stop there."""
    if budgets is None:
        return num_steps
    return min(num_steps, max(int(budgets.max()), 0)) if budgets.numel() else 0


def cd_residual_plain(a_cols, x_parts, grads, lin_parts, masks, *, num_steps,
                      sigma_over_tau, l1, l2, box, budgets=None):
    """Plain version of ``cd_residual_kernel``: a_cols (K, n_k, d)."""
    k, n_k, d = a_cols.shape
    sot = float(sigma_over_tau)
    q = sot * torch.sum(a_cols * a_cols, dim=-1)            # (K, n_k)
    dx = torch.zeros_like(x_parts)
    r = torch.zeros_like(grads)
    for t in range(_live_range(num_steps, budgets)):
        i = t % n_k
        a_i = a_cols[:, i, :]                               # (K, d)
        z = x_parts[:, i] + dx[:, i]
        g = torch.sum(a_i * (grads + sot * r), dim=-1)
        live = (t < budgets) if budgets is not None else True
        delta = _prox_delta(z, g, q[:, i], lin_parts[:, i], masks[:, i],
                            live, l1, l2, box)
        dx[:, i] += delta
        r += a_i * delta[:, None]
    return dx


def cd_gram_plain(gram_parts, x_parts, atg_parts, lin_parts, masks, *,
                  num_steps, sigma_over_tau, l1, l2, box, budgets=None):
    """Plain version of ``cd_gram_kernel``: gram (K, n_k, n_k)."""
    k, n_k, _ = gram_parts.shape
    sot = float(sigma_over_tau)
    q = sot * torch.diagonal(gram_parts, dim1=1, dim2=2)    # ||A_i||^2
    dx = torch.zeros_like(x_parts)
    h = torch.zeros_like(x_parts)
    for t in range(_live_range(num_steps, budgets)):
        i = t % n_k
        z = x_parts[:, i] + dx[:, i]
        g = atg_parts[:, i] + sot * h[:, i]
        live = (t < budgets) if budgets is not None else True
        delta = _prox_delta(z, g, q[:, i], lin_parts[:, i], masks[:, i],
                            live, l1, l2, box)
        dx[:, i] += delta
        h += gram_parts[:, :, i] * delta[:, None]
    return dx


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, tensors: dict, shapes: dict, device) -> None:
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, want {device}")
        want = torch.int32 if key == "budgets" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, want {want}")
        if tuple(t.shape) != shapes[key]:
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"want {shapes[key]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")


def cd_solve_blocks(a_cols, x_parts, grads, lin_parts, masks, *, num_steps: int,
                    sigma_over_tau: float, l1: float, l2: float, box: float,
                    budgets=None) -> torch.Tensor:
    """Solve all K node subproblems, residual formulation.

    Args:
      a_cols: (K, n_k, d) rows A_i of every node's column block.
      x_parts / lin_parts / masks: (K, n_k); grads: (K, d).
      num_steps: coordinate updates per node (kappa * n_k).
      budgets: optional (K,) int32 per-node step budgets.

    Returns dx_parts: (K, n_k).
    """
    l1, l2, box = float(l1), float(l2), float(box)
    kw = dict(num_steps=int(num_steps), sigma_over_tau=sigma_over_tau,
              l1=l1, l2=l2, box=box, budgets=budgets)
    dev = a_cols.device
    if dev.type == "cpu":
        return cd_residual_plain(a_cols, x_parts, grads, lin_parts, masks, **kw)
    if dev.type != "cuda":
        raise ValueError(f"cd_solve_blocks: unsupported device {dev}")
    k, n_k, d = a_cols.shape
    tensors = dict(a_cols=a_cols, x_parts=x_parts, grads=grads,
                   lin_parts=lin_parts, masks=masks)
    shapes = dict(a_cols=(k, n_k, d), x_parts=(k, n_k), grads=(k, d),
                  lin_parts=(k, n_k), masks=(k, n_k), budgets=(k,))
    if budgets is not None:
        tensors["budgets"] = budgets
    _check("cd_solve_blocks", tensors, shapes, dev)
    return _residual_launch(a_cols, x_parts, grads, lin_parts, masks,
                            RESIDUAL_THREADS, **kw)


def _residual_launch(a_cols, x_parts, grads, lin_parts, masks, threads, *,
                     num_steps, sigma_over_tau, l1, l2, box, budgets):
    """Launch ``cd_residual_kernel`` on checked CUDA inputs with ``threads``
    threads per node's block. ``cd_solve_blocks`` passes
    ``RESIDUAL_THREADS``; the other counts serve the block-size measurement
    in ``chip_smoke.py`` and the card tests of those counts."""
    k, n_k, d = a_cols.shape
    dev = a_cols.device
    dx = torch.empty((k, n_k), dtype=torch.float32, device=dev)
    # r spills to (K, d) scratch when the layout puts it in global memory
    scratch = torch.empty((k, d), dtype=torch.float32, device=dev)
    from repro_torch.kernels import build
    rc = build.load("cd_glm").cd_residual_launch(
        a_cols.data_ptr(), x_parts.data_ptr(), grads.data_ptr(),
        lin_parts.data_ptr(), masks.data_ptr(),
        budgets.data_ptr() if budgets is not None else None,
        dx.data_ptr(), scratch.data_ptr(), k, d, n_k, int(num_steps),
        float(sigma_over_tau), float(l1), float(l2), float(box), threads,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cd_residual_kernel launch failed: CUDA error {rc}")
    LAUNCHES["cd_residual"] += 1
    return dx


def cd_solve_blocks_gram(gram_parts, x_parts, atg_parts, lin_parts, masks, *,
                         num_steps: int, sigma_over_tau: float, l1: float,
                         l2: float, box: float, budgets=None,
                         gram_cols=None) -> torch.Tensor:
    """Gram-cached variant of ``cd_solve_blocks``.

    Args:
      gram_parts: (K, n_k, n_k) node-local Gram blocks A_[k]^T A_[k].
      atg_parts: (K, n_k) per-node A_[k]^T grad_f(v_k).
      x_parts / lin_parts / masks: (K, n_k); budgets: optional (K,) int32.
      gram_cols: optional ``gram_columns(gram_parts)``, the kernel's layout
        (``ColaEnv.gram_cols``); built here when omitted. The plain version
        reads ``gram_parts``.

    Returns dx_parts: (K, n_k).
    """
    l1, l2, box = float(l1), float(l2), float(box)
    kw = dict(num_steps=int(num_steps), sigma_over_tau=sigma_over_tau,
              l1=l1, l2=l2, box=box, budgets=budgets)
    dev = gram_parts.device
    if dev.type == "cpu":
        return cd_gram_plain(gram_parts, x_parts, atg_parts, lin_parts, masks,
                             **kw)
    if dev.type != "cuda":
        raise ValueError(f"cd_solve_blocks_gram: unsupported device {dev}")
    k, n_k, _ = gram_parts.shape
    if n_k > GRAM_MAX_NK:
        raise ValueError(f"cd_solve_blocks_gram: the Gram kernel takes n_k <= "
                         f"{GRAM_MAX_NK}, got {n_k}")
    if gram_cols is None:
        gram_cols = gram_columns(gram_parts)
    tensors = dict(gram_parts=gram_parts, gram_cols=gram_cols,
                   x_parts=x_parts, atg_parts=atg_parts, lin_parts=lin_parts,
                   masks=masks)
    shapes = dict(gram_parts=(k, n_k, n_k), gram_cols=(k, n_k, gram_ld(n_k)),
                  x_parts=(k, n_k), atg_parts=(k, n_k), lin_parts=(k, n_k),
                  masks=(k, n_k), budgets=(k,))
    if budgets is not None:
        tensors["budgets"] = budgets
    _check("cd_solve_blocks_gram", tensors, shapes, dev)
    dx = torch.empty((k, n_k), dtype=torch.float32, device=dev)
    from repro_torch.kernels import build
    rc = build.load("cd_glm").cd_gram_launch(
        gram_cols.data_ptr(), x_parts.data_ptr(), atg_parts.data_ptr(),
        lin_parts.data_ptr(), masks.data_ptr(),
        budgets.data_ptr() if budgets is not None else None,
        dx.data_ptr(), k, n_k, gram_ld(n_k), int(num_steps),
        float(sigma_over_tau), l1, l2, box, int(gram_fits_smem(n_k)),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"cd_gram_kernel launch failed: CUDA error {rc}")
    LAUNCHES["cd_gram"] += 1
    return dx
