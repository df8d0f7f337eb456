# CoLA's core in PyTorch: problems, partition, topology, the local CD solver,
# gossip mixing and the quantized wire, duality gaps and certificates,
# recorders, streamed schedules and client sampling, the round-block
# executor and the Algorithm-1 driver.
from repro_torch.core import (  # noqa: F401
    cola,
    duality,
    executor,
    metrics,
    mixing,
    partition,
    problems,
    quant,
    schedule,
    streams,
    subproblem,
    topology,
)
from repro_torch.core.cola import ColaConfig, ColaState, run_cola  # noqa: F401
from repro_torch.core.problems import PROBLEMS, Problem  # noqa: F401
