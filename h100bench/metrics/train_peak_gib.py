"""``torch.cuda.max_memory_allocated`` over the window, reset at its start, in GiB."""


def read(record):
    if "window_peak_bytes" not in record:
        return None
    return record["window_peak_bytes"] / 2 ** 30
