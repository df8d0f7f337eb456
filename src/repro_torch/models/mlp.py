"""Feed-forward layers: SwiGLU MLP and Mixture-of-Experts (counterpart of
``repro.models.mlp``).

MoE uses capacity-based dispatch, in the reference's modes on one device:

* ``dense`` — every expert processes every token, outputs combined by the
  router weights. Exact (no dropping): the oracle.
* ``scatter`` — each (token, choice) pair is scattered into its expert's
  capacity buffer of C slots, the experts run batched products over their
  buffers, and the outputs are gathered back. A pair whose rank among its
  expert's pairs (token-major) is >= C is dropped: it adds 0 and gets 0.
  With ``dispatch_groups`` G > 1 the tokens split into G equal groups,
  each with its own C slots per expert (the reference's ``vmap`` over
  groups, here one buffer of G * C slots per expert).

Expert parallelism (scatter mode with ``mesh`` and ``model_axis``): the
reference's ``shard_map`` over the ``model`` axis becomes the ranks of
``mesh.get_group(model_axis)`` as a ``NodeAxis`` (``expert_axis``). Each
of the M ranks runs the capacity dispatch for its E/M experts, at offset
``index * E/M``, with the capacity of all T tokens (every rank sees every
token, so the drops are the single-process drops), and one ``psum`` of the
(T, d) output combines them: no all-to-all, no token shuffle. Grouped
dispatch is ignored under a model axis, as in the reference. **Which
expert weights a rank holds:** the whole stacked leaves; each rank reads
its (E/M, ...) block as a view, as ``shard_map``'s ``in_specs=P(model)``
cuts it, so the gradient of a leaf is nonzero on the rank's block only.
The backward is two autograd Functions (``NodeAxis.psum`` alone carries
no gradient): ``_ReplicatedIn`` (identity forward, ``psum`` backward) on
the replicated inputs ``x_flat`` and ``w_topk``, as ``shard_map`` sums the
cotangent of a ``P()`` input over the axis, so the router and the layers
below get whole gradients; ``_SumOut`` (``psum`` forward, identity
backward) on the output.

The products are plain batched products and index scatters: the reference
computes them in jnp, outside any Pallas kernel.

Parameters are dicts of tensors with the reference's names and layouts:
``*_leaves`` give the shapes and initializers, ``*_init`` draw them.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import dense_leaf, init_tree


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------

def mlp_leaves(d_model: int, d_ff: int) -> dict:
    """SwiGLU weights stored (in, out), as the reference stores them."""
    return {"w_gate": dense_leaf((d_model, d_ff)),
            "w_up": dense_leaf((d_model, d_ff)),
            "w_down": dense_leaf((d_ff, d_model))}


def mlp_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.nn.functional.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_leaves(d_model: int, d_ff: int, num_experts: int,
               shared_expert: bool = False) -> dict:
    e = num_experts
    p = {"router": dense_leaf((d_model, e)),
         "w_gate": dense_leaf((e, d_model, d_ff), fan_in=d_model),
         "w_up": dense_leaf((e, d_model, d_ff), fan_in=d_model),
         "w_down": dense_leaf((e, d_ff, d_model), fan_in=d_ff)}
    if shared_expert:
        p["shared"] = mlp_leaves(d_model, d_ff)
    return p


def moe_init(generator, d_model: int, d_ff: int, num_experts: int, dtype,
             device, shared_expert: bool = False) -> dict:
    """router (d, E), w_gate / w_up (E, d, f), w_down (E, f, d), and the
    shared expert's SwiGLU. The reference draws the router in fp32; here
    every leaf is in ``dtype``, as its ``compute_cast`` leaves them."""
    return init_tree(generator, moe_leaves(d_model, d_ff, num_experts,
                                           shared_expert), dtype, device)


def _router(p: dict, x_flat: torch.Tensor, experts_per_token: int):
    """Top-k routing. Returns (weights (T, k) f32, idx (T, k) int64, aux).
    The product is fp32 over the router as stored (bf16-rounded when the
    model serves in bf16, as the reference's ``compute_cast`` rounds it)."""
    logits = x_flat.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, experts_per_token, dim=-1)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    # Switch-style load-balance auxiliary loss, on the first choice only
    t, e = probs.shape
    counts = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    counts.index_add_(0, idx[:, 0], torch.ones((t,), dtype=torch.float32,
                                               device=probs.device))
    aux = e * torch.sum(counts / t * torch.mean(probs, dim=0))
    return w, idx, aux


def _expert_ffn(w_gate, w_up, w_down, buf):
    """buf: (E, C, d) -> (E, C, d) through per-expert SwiGLU."""
    h = torch.nn.functional.silu(torch.bmm(buf, w_gate))
    h = h * torch.bmm(buf, w_up)
    return torch.bmm(h, w_down)


def _scatter_moe_local(w_gate, w_up, w_down, x_flat, w_topk, idx, capacity,
                       e_offset, num_local_experts, groups: int = 1):
    """Capacity dispatch for the experts [e_offset, e_offset + E_loc).

    x_flat: (T, d); w_topk / idx: (T, k). Pairs routed to other experts
    are dropped here. With ``groups`` G the T tokens are G equal groups of
    consecutive tokens, each with its own ``capacity`` slots per expert.
    """
    t, k = idx.shape
    d = x_flat.shape[-1]
    e_loc = num_local_experts
    flat_e = idx.reshape(-1) - e_offset                      # (T*k,)
    local = (flat_e >= 0) & (flat_e < e_loc)
    flat_e_c = torch.where(local, flat_e, 0)
    # rank of each (token, choice) among its group's pairs to its expert,
    # in token-major order: a cumulative count over one-hot rows
    col = torch.where(local, flat_e, e_loc)[:, None]
    oh = torch.zeros((t * k, e_loc + 1), dtype=torch.int32,
                     device=x_flat.device).scatter_(1, col, 1)
    pos = torch.cumsum(oh.reshape(groups, t * k // groups, e_loc + 1),
                       dim=1).reshape(t * k, e_loc + 1)
    pos = torch.gather(pos, 1, col)[:, 0] - 1                # (T*k,)
    keep = local & (pos < capacity)
    group = torch.arange(t * k, device=x_flat.device) // (t * k // groups)
    slot = group * capacity + torch.clamp(pos, 0, capacity - 1)

    tok = torch.arange(t * k, device=x_flat.device) // k
    contrib = x_flat[tok] * keep[:, None].to(x_flat.dtype)
    buf = torch.zeros((e_loc, groups * capacity, d), dtype=x_flat.dtype,
                      device=x_flat.device)
    # a dropped pair adds its zero row to a clamped slot, as the reference's
    # scatter-add does
    buf.index_put_((flat_e_c, slot), contrib, accumulate=True)

    out_buf = _expert_ffn(w_gate, w_up, w_down, buf)         # (E_loc, GC, d)

    gathered = out_buf[flat_e_c, slot]                       # (T*k, d)
    gathered = gathered * (keep[:, None].float()
                           * w_topk.reshape(-1)[:, None]).to(x_flat.dtype)
    return torch.sum(gathered.reshape(t, k, d), dim=1)


def moe_capacity(tokens: int, experts_per_token: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Slots per expert (per dispatch group): the reference's formula,
    with Python's round (half to even)."""
    return max(1, int(round(tokens * experts_per_token / num_experts
                            * capacity_factor)))


# ---------------------------------------------------------------------------
# expert parallelism over the ranks of a model axis
# ---------------------------------------------------------------------------

_AXES: dict = {}


def expert_axis(mesh, model_axis: str):
    """The ``NodeAxis`` over ``mesh``'s ``model_axis`` ranks (one per
    process group, so its counts accumulate over the layers)."""
    from repro_torch.dist.axis import NodeAxis
    group = mesh.get_group(model_axis)
    if group not in _AXES:
        _AXES[group] = NodeAxis(group)
    return _AXES[group]


class _ReplicatedIn(torch.autograd.Function):
    """A replicated input of the expert-parallel body: identity forward,
    the cotangent summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum(g.contiguous()), None


class _SumOut(torch.autograd.Function):
    """The body's output: summed over the axis forward, its cotangent
    passed through (every rank's partial gets the whole cotangent)."""

    @staticmethod
    def forward(ctx, y, axis):
        return axis.psum(y)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _expert_parallel(p: dict, x_flat, w_topk, idx, capacity: int, axis):
    """The experts [index * E/M, (index + 1) * E/M) of this rank on every
    token, summed over the axis."""
    e = p["w_gate"].shape[0]
    if e % axis.size:
        raise ValueError(f"{e} experts do not split over {axis.size} ranks "
                         "of the model axis")
    e_loc = e // axis.size
    rows = slice(axis.index * e_loc, (axis.index + 1) * e_loc)
    out = _scatter_moe_local(
        p["w_gate"][rows], p["w_up"][rows], p["w_down"][rows],
        _ReplicatedIn.apply(x_flat, axis), _ReplicatedIn.apply(w_topk, axis),
        idx, capacity, axis.index * e_loc, e_loc)
    return _SumOut.apply(out, axis)


def moe_apply(p: dict, x: torch.Tensor, *, experts_per_token: int,
              capacity_factor: float = 1.25, mode: str = "scatter",
              mesh=None, model_axis: str | None = None,
              dispatch_groups: int = 0, group_axes=None):
    """Apply the MoE layer. x: (B, S, d). Returns (y, aux_loss).

    ``dispatch_groups`` > 1 selects token-grouped scatter dispatch (not
    under a model axis). Its ``group_axes`` sharding constraints change no
    value in one process. With ``mesh`` and ``model_axis``, scatter mode
    is expert-parallel over that axis's ranks (see the module).
    """
    if mode not in ("scatter", "dense"):
        raise ValueError(f"unknown MoE mode {mode!r}")
    b, s, d = x.shape
    t = b * s
    x_flat = x.reshape(t, d)
    w_topk, idx, aux = _router(p, x_flat, experts_per_token)
    e = p["w_gate"].shape[0]

    if mode == "dense":
        # the oracle: all experts on all tokens
        h = torch.nn.functional.silu(torch.matmul(x_flat, p["w_gate"]))
        h = h * torch.matmul(x_flat, p["w_up"])              # (E, T, f)
        all_out = torch.bmm(h, p["w_down"])                  # (E, T, d)
        comb = torch.zeros((t, e), dtype=torch.float32,
                           device=x.device).scatter_add_(1, idx, w_topk)
        y = torch.einsum("te,etd->td", comb.to(x.dtype), all_out)
    elif mesh is not None and model_axis is not None:
        capacity = moe_capacity(t, experts_per_token, e, capacity_factor)
        y = _expert_parallel(p, x_flat, w_topk, idx, capacity,
                             expert_axis(mesh, model_axis))
    else:
        g = (dispatch_groups if dispatch_groups > 1 and model_axis is None
             else 1)
        if t % g:
            raise ValueError(f"{t} tokens do not split into {g} dispatch "
                             "groups")
        capacity = moe_capacity(t // g, experts_per_token, e,
                                capacity_factor)
        y = _scatter_moe_local(p["w_gate"], p["w_up"], p["w_down"], x_flat,
                               w_topk, idx, capacity, 0, e, groups=g)

    if "shared" in p:
        y = y + mlp_apply(p["shared"], x_flat)
    return y.reshape(b, s, d), aux
