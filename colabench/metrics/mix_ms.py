"""mix_ms (ms, program span): the card's time in the round's gossip mix
(the port's ``cola.mix`` span, ``device_s``) over the rounds executed
(``round`` spans), in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("cola.mix", "device_s", per="round")
