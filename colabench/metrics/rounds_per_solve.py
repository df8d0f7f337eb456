"""rounds_per_solve (rounds, program counter): the rounds the block
executor ran per solve, the stop round plus the rest of its block, from
the solves' histories; each solve's CD kernel launches must count the same
(``cd_glm.LAUNCHES``: one per executed round), or the metric is left out."""


def read(record):
    solves = record["solves"]
    for s in solves:
        if sum(s["launches"].values()) != s["executed_rounds"]:
            return None
    return sum(s["executed_rounds"] for s in solves) / len(solves)
