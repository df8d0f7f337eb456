"""local_solve_ms (ms, program span): the card's time in the round's local
solve (the port's ``cola.local_solve`` span, ``device_s``: grad f, the CD
kernel, the active and work masks) over the rounds executed (``round``
spans), in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("cola.local_solve", "device_s", per="round")
