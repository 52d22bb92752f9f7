"""The megakernel's least time per frame over its device time per frame,
in %. The least time is the larger of the frame's float32 operations over
67 TFLOP/s and its bytes over 3.35 TB/s, the work counted by the frozen
reference (reference/work.py)."""

from perfbench.harness import PEAK_BYTES, PEAK_FP32
from perfbench.metrics_common import megakernel_ms_per_frame


def read(record):
    ms = megakernel_ms_per_frame(record)
    if ms is None:
        return None
    work = record["work"]
    least_ms = max(work["flops"] / PEAK_FP32, work["bytes"] / PEAK_BYTES) * 1e3
    return 100.0 * least_ms / ms
