"""solve_setup_ms (ms, program span): the card's time in ``run_cola``'s
per-call set-up (the port's ``cola.setup`` span, ``device_s``: A's block
copy, the Gram blocks or the residual layout, σ_k, the schedule, the
round body) per solve, in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("cola.setup", "device_s")
