"""Column partitioning of the data matrix A over K nodes (paper §1.1).

Equal-size contiguous blocks, with zero-padding of A's columns when
``n % K != 0``, so the per-node state stacks into dense ``(K, d, n_k)`` /
``(K, n_k)`` tensors. Padded columns are all-zero, so their coordinate
updates are exact no-ops, and ``g`` contributions of padded coordinates are
masked out.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Partition:
    """Equal block partition of n columns over K nodes."""

    num_nodes: int
    n: int            # true number of coordinates
    block: int        # n_k, coordinates per node (after padding)

    @property
    def n_padded(self) -> int:
        return self.num_nodes * self.block

    def pad_width(self) -> int:
        return self.n_padded - self.n

    def mask(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """(K, block) mask: 1 for real coordinates, 0 for padding."""
        flat = torch.arange(self.n_padded, device=device) < self.n
        return flat.reshape(self.num_nodes, self.block).to(dtype)

    def split_matrix(self, a: torch.Tensor) -> torch.Tensor:
        """(d, n) -> contiguous (K, d, block) column blocks."""
        d, n = a.shape
        if n != self.n:
            raise ValueError(f"matrix has {n} columns, partition has {self.n}")
        a_pad = F.pad(a, (0, self.pad_width()))
        return a_pad.reshape(d, self.num_nodes, self.block).movedim(1, 0) \
            .contiguous()

    def split_vector(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) -> (K, block)."""
        return F.pad(x, (0, self.pad_width())).reshape(self.num_nodes,
                                                       self.block)

    def merge_vector(self, x_parts: torch.Tensor) -> torch.Tensor:
        """(K, block) -> (n,)."""
        return x_parts.reshape(-1)[: self.n]


def make_partition(n: int, num_nodes: int) -> Partition:
    block = -(-n // num_nodes)  # ceil division
    return Partition(num_nodes=num_nodes, n=n, block=block)

