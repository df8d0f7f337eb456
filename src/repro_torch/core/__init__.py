# CoLA's core in PyTorch: problems, partition, topology, the local CD solver,
# gossip mixing, duality gaps and certificates, recorders, the round-block
# executor and the Algorithm-1 driver.
from repro_torch.core import (  # noqa: F401
    cola,
    duality,
    executor,
    metrics,
    mixing,
    partition,
    problems,
    subproblem,
    topology,
)
from repro_torch.core.cola import ColaConfig, ColaState, run_cola  # noqa: F401
from repro_torch.core.problems import PROBLEMS, Problem  # noqa: F401
