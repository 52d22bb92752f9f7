"""The 95th percentile of the walls of every frame completed in the
window, from the call's start to its return (host clock), in ms."""

from perfbench.harness import percentile


def read(record):
    if record.get("kind") != "frame" or not record["frames"]:
        return None
    return percentile(record["frame_walls_s"], 95) * 1e3
