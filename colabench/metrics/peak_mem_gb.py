"""peak_mem_gb (GB, the allocator's counter): the most the port held on
the card at once during the window (``torch.cuda.max_memory_allocated``
after a reset at the end of set-up), in 1e9 bytes."""


def read(record):
    return record["peak_mem_bytes"] / 1e9 if record["peak_mem_bytes"] \
        else None
