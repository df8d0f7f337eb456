"""setup_s (s, host clock): process start to the first timed solve: the
imports, the card's context, loading (or, in a fresh checkout, building)
the CD kernels, the data on the card and one warm-up block."""


def read(record):
    return record["setup_s"]
