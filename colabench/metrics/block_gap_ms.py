"""block_gap_ms (ms, program span): the host's time from a block's
stop-flag read to the next block's first round (the port's ``block-gap``
span, ``total_s``: the card is drained then, so the card idles for it)
per gap, in the traced solve."""
from colabench import program_spans


def read(record):
    return program_spans.ms("block-gap", "total_s")
