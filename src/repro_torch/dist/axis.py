"""The node axis over the ranks of a ``torch.distributed`` process group.

The JAX reference lays COLA's node axis over a mesh axis and reaches the
other devices with ``lax`` collectives inside ``shard_map``. ``NodeAxis``
is the same vocabulary on a process group (NCCL on the card, gloo on the
CPU), so the lowering reads like the reference's:

* ``index`` and ``size`` — ``lax.axis_index`` and the axis size;
* ``permute(x, pairs)`` — ``lax.ppermute``: (src, dst) pairs, a rank that
  is no pair's destination receives zeros; one ``batch_isend_irecv`` per
  call (a pair (i, i) is a local copy: torch refuses a send to oneself);
* ``psum``, ``pmax`` — all-reduces; ``all_gather`` — tiled on the node
  axis; ``broadcast`` — rank ``src``'s tensor on every rank.

A 1-byte tensor (int8, float8) crosses ``permute`` and ``all_gather`` as
its uint8 bits and is viewed back: no backend upcasts it (gloo takes no
float8), so a quantized payload moves 1 byte an element.

Every call adds one to ``counts[kind]`` and the bytes this rank sends to
``sent_bytes[kind]`` (kinds: "permute", "all-reduce", "all-gather",
"broadcast"), on every rank, whether it is matched in that call or not:
the tests hold a round's counts to the plan's ``contract()``.

Every rank must make the same calls in the same order. NCCL must see a
collective before its first point-to-point call: ``warm_up`` makes one.
"""
from __future__ import annotations

import collections

import torch
import torch.distributed as dist


def _as_bytes(x: torch.Tensor) -> bool:
    """A 1-byte tensor that is not already uint8 (sent as its bits)."""
    return x.element_size() == 1 and x.dtype != torch.uint8


class NodeAxis:
    """One process group's ranks as the node axis (``group=None``: the
    default group, which the caller has initialised)."""

    def __init__(self, group=None):
        if not dist.is_initialized():
            raise RuntimeError(
                "repro_torch.dist: no process group — call "
                "torch.distributed.init_process_group first")
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.counts: collections.Counter = collections.Counter()
        self.sent_bytes: collections.Counter = collections.Counter()

    def reset_counts(self) -> None:
        self.counts.clear()
        self.sent_bytes.clear()

    def _count(self, kind: str, nbytes: int) -> None:
        self.counts[kind] += 1
        self.sent_bytes[kind] += nbytes

    def _peer(self, rank: int) -> int:
        """A rank of the group as the global rank P2P ops take."""
        return rank if self.group is None else \
            dist.get_global_rank(self.group, rank)

    def warm_up(self, device) -> None:
        """One all-reduce on ``device``, uncounted: NCCL sets its
        communicator up on a collective, before any point-to-point call."""
        dist.all_reduce(torch.zeros((1,), device=device), group=self.group)

    def permute(self, x: torch.Tensor, pairs) -> torch.Tensor:
        """``lax.ppermute``: each (src, dst) pair sends src's ``x`` to dst;
        the result is what this rank receives, zeros if nothing."""
        if _as_bytes(x):
            return self.permute(x.contiguous().view(torch.uint8),
                                pairs).view(x.dtype)
        srcs = [s for s, d in pairs if d == self.index]
        dsts = [d for s, d in pairs if s == self.index]
        if len(srcs) > 1 or len(dsts) > 1:
            raise ValueError(f"permute pairs are not a permutation at rank "
                             f"{self.index}: {list(pairs)}")
        x = x.contiguous()
        nbytes = x.numel() * x.element_size()
        out = torch.zeros_like(x)
        ops = []
        for d in dsts:
            if d == self.index:
                out.copy_(x)
            else:
                ops.append(dist.P2POp(dist.isend, x, self._peer(d),
                                      self.group))
        for s in srcs:
            if s != self.index:
                ops.append(dist.P2POp(dist.irecv, out, self._peer(s),
                                      self.group))
        self._count("permute", nbytes * sum(d != self.index for d in dsts))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        out = x.clone()
        self._count("all-reduce", out.numel() * out.element_size())
        dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on dim 0, in rank order."""
        if _as_bytes(x):
            return self.all_gather(x.contiguous().view(torch.uint8)).view(
                x.dtype)
        x = x.contiguous()
        self._count("all-gather", x.numel() * x.element_size())
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=0)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        out = x.clone()
        self._count("broadcast",
                    out.numel() * out.element_size()
                    if self.index == src else 0)
        dist.broadcast(out, self._peer(src), group=self.group)
        return out
