"""round_ms (ms, host clock): the window's milliseconds over the rounds
executed in it, over whole solves (run_cola's set-up in each call
included)."""


def read(record):
    rounds = sum(s["executed_rounds"] for s in record["solves"])
    return record["window_s"] * 1e3 / rounds
