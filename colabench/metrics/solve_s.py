"""solve_s (s, host clock): the window's wall seconds over the solves
finished in it. A solve is one ``run_cola`` call to the cell's target."""


def read(record):
    return record["window_s"] / len(record["solves"])
