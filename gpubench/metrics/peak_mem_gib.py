"""peak_mem_gib: the allocator's peak on the card from the start of
set-up to the end of the window (``torch.cuda.max_memory_allocated``);
the check after it is not counted."""


def read(record):
    peak = record["memory"]["peak_bytes"]
    return None if peak is None else peak / 2 ** 30
