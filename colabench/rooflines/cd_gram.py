"""The work of one launch of the Gram-cached CD kernel (``cd_gram_kernel``):
``steps`` coordinate updates on each of K nodes' (n_k, n_k) Gram blocks.

Bytes: each input read once (G, and x, A^T grad, the prox's labels and the
mask, each (K, n_k); K budgets) and dx (K, n_k) written once, in fp32.
FLOPs: a step is an n_k-long axpy on h = G dx (2 n_k) and about 12
operations of the prox. The same count as ``chip_smoke.py``'s
``gram_cost``, whatever computes the steps.
"""


def cost(k: int, n_k: int, steps: int) -> tuple[float, float]:
    nbytes = 4 * (k * n_k * n_k + 4 * k * n_k + k) + 4 * k * n_k
    flops = k * steps * (2 * n_k + 12)
    return float(nbytes), float(flops)
