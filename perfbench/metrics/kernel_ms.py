"""Device time per frame of the kernels whose name holds "megakernel",
from torch.profiler over the profiled frames: the mean of the launches
the profiler kept, times the launches per frame (the program's own
launch counter), in ms."""

from perfbench.metrics_common import megakernel_ms_per_frame


def read(record):
    return megakernel_ms_per_frame(record)
