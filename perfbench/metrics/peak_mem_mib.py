"""torch.cuda.max_memory_allocated() over the window, after
reset_peak_memory_stats() at its start, in MiB."""


def read(record):
    if record.get("kind") != "inverse" or record.get("window_peak_bytes") is None:
        return None
    return record["window_peak_bytes"] / 2**20
