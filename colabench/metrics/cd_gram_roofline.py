"""cd_gram_roofline (%, device trace): the least time of one launch of
``cd_gram_kernel`` (``rooflines/cd_gram.py`` at the cell's shapes) over
its device time per launch in the traced solve. Nothing where the kernel
did not run."""
from colabench import peaks, registry

KERNEL = "cd_gram_kernel"


def read(record):
    trace = record["trace"]
    hits = [v for name, v in (trace or {}).get("kernels", {}).items()
            if KERNEL in name]
    calls = sum(v["calls"] for v in hits)
    if not calls:
        return None
    s = record["shapes"]
    nbytes, flops = registry.load_module("rooflines", "cd_gram").cost(
        s["k"], s["n_k"], s["steps"])
    least, _ = peaks.least_seconds(nbytes, flops)
    return 100.0 * least / (sum(v["device_s"] for v in hits) / calls)
