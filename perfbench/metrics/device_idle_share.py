"""1 - device busy / host wall over the profiled slice (frames, or Adam
steps): busy sums the device's own events (kernels, copies, fills), as
profile_render.py counts it."""

from perfbench.metrics_common import idle_share


def read(record):
    return idle_share(record)
