"""update_ms (ms, program span): the card's time in the round's updates
(the port's ``cola.update`` span, ``device_s``: x, A dx and v) over the
rounds executed (``round`` spans), in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("cola.update", "device_s", per="round")
