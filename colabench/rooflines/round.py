"""The work that one COLA round needs, with the recorder's share at its
cadence, from the cell's shapes: what ``round_mfu`` divides by the time.

A round (Algorithm 1) on K nodes, A (d, n) in K column blocks of n_k:
mix v through W, take grad f, solve each node's subproblem by ``steps``
coordinate updates, update x and v. Counted so that no implementation
needs less, each input byte read once and each output byte written once
(fp32):

* A, once: every form of the local solve needs each column once (the
  Gram form reads it for A^T grad and again for A dx, the residual form
  once for both; only the least is counted, and nothing that one form
  derives, such as the Gram blocks);
* v (K, d) read and written, x (K, n_k) read and written, the data term
  (y over d for the lasso, labels over n for the ridge dual) and W (K, K);
* FLOPs: A^T grad and A dx (4 d n), the mix over W's nonzeros
  (2 nnz(W) d), the gradient (K d) and the prox (12 a coordinate step).

A record round adds the recorder's work, each input once: the gap row
reads A once (A x and A^T w share a pass) and v, with 4 d n FLOPs; the
certificate adds A^T grad of every node (2 d n) over the same pass.
"""


def cost(k: int, d: int, n: int, n_k: int, steps: int, nnz_w: int,
         data_len: int, record_every: int,
         certificate: bool) -> tuple[float, float]:
    """(bytes, FLOPs) a round, the recorder's share averaged over its
    cadence. ``data_len``: the data term's length (d or n)."""
    nbytes = 4 * (d * n + 2 * k * d + 2 * k * n_k + data_len + k * k)
    flops = 4 * d * n + 2 * nnz_w * d + k * d + 12 * k * steps
    rec_bytes = 4 * (d * n + k * d + k * n_k)
    rec_flops = 4 * d * n + (2 * d * n + k * d if certificate else 0)
    return (float(nbytes + rec_bytes / record_every),
            float(flops + rec_flops / record_every))
