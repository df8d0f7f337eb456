"""Published dense peaks of one NVIDIA H100 SXM5 80GB.

Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 column, dense rates
(without sparsity), at the card's full power limit of 700 W. A card set
below that runs slower under load: ``card()`` reads the name and power
limit of the card a run used, and the result prints them beside every
share of a peak.
"""
from __future__ import annotations

import subprocess

SOURCE = ("NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense: 3.35 TB/s "
          "HBM3, 67 TFLOP/s FP32, 495 TFLOP/s TF32, 989 TFLOP/s BF16; 700 W")
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12          # outside the tensor cores: the CD kernels' and
#                             the fp32 products' units


def least_seconds(nbytes: float, flops: float,
                  flops_peak: float = FP32_FLOPS) -> tuple[float, str]:
    """The least time the card can take for work of ``nbytes`` and
    ``flops``: the larger of bytes over the HBM rate and FLOPs over the
    peak of the units that do the work; and which of the two bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def card() -> dict:
    """The name and power limit of card 0, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {"name": None, "power_limit": None}
    name, _, limit = out.partition(",")
    return {"name": name.strip(), "power_limit": limit.strip()}
