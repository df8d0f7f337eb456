"""device_idle (%, device trace): the share of the traced solve in which
no operation ran on the card (1 - busy / window, from the profiler)."""


def read(record):
    trace = record["trace"]
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
