"""round_mfu (%, host clock): the least time the card needs for one
round's work (``rooflines/round.py``, the recorder's share at its
cadence; the larger of bytes over the HBM rate and FLOPs over the FP32
peak, ``peaks.py``) over ``round_ms``: the whole round's share of the
card's peak."""
from colabench import peaks, registry


def read(record):
    s = record["shapes"]
    nbytes, flops = registry.load_module("rooflines", "round").cost(
        s["k"], s["d"], s["n"], s["n_k"], s["steps"], s["nnz_w"],
        s["data_len"], s["record_every"], s["certificate"])
    least, _ = peaks.least_seconds(nbytes, flops)
    rounds = sum(x["executed_rounds"] for x in record["solves"])
    return 100.0 * least / (record["window_s"] / rounds)
