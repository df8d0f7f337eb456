"""The work of one launch of the residual CD kernel (``cd_residual_kernel``):
``steps`` coordinate updates on each of K nodes' (d, n_k) column blocks,
carrying r = A_[k] dx.

Bytes: each input read once (the block's n_k columns of length d; x, the
prox's labels and the mask, each (K, n_k); the gradients (K, d); K
budgets) and dx (K, n_k) written once, in fp32. FLOPs: a step is a d-long
dot product and a d-long axpy (4 d), and the columns' squared norms take
2 n_k d. The same count as ``chip_smoke.py``'s ``residual_cost``,
whatever computes the steps.
"""


def cost(k: int, n_k: int, d: int, steps: int) -> tuple[float, float]:
    nbytes = 4 * (k * n_k * d + 3 * k * n_k + k * d + k) + 4 * k * n_k
    flops = k * (steps * 4 * d + 2 * n_k * d)
    return float(nbytes), float(flops)
