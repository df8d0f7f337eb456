"""record_ms (ms, program span): the card's time in one record (the
port's ``round-record`` span, ``device_s``: the recorder's row and the
stop-flag update) per record round, in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("round-record", "device_s")
