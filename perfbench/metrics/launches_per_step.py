"""CUDA kernels per Adam step over the profiled steps (device events
that are kernels, copies and fills excluded)."""


def read(record):
    prof = record.get("profile")
    if record.get("kind") != "inverse" or not prof:
        return None
    kernels = sum(count for name, (count, _) in prof["kernels"].items()
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / prof["steps"]
