"""The whole frame's share of the card's float32 peak, in %: the frame's
float32 operations (counted by the frozen reference, reference/work.py)
over 67 TFLOP/s, over the mean wall of the traced window's frames."""

from perfbench.harness import PEAK_FP32


def read(record):
    if record.get("kind") != "frame" or "work" not in record or not record["frames"]:
        return None
    wall = sum(record["frame_walls_s"]) / record["frames"]
    return 100.0 * record["work"]["flops"] / PEAK_FP32 / wall
