"""Primary rays of every frame completed in the window (width x height x
spp each), in millions, over the window's whole time (host clock)."""


def read(record):
    if record.get("kind") != "frame" or not record["frames"]:
        return None
    return record["frames"] * record["rays_per_frame"] / record["window_s"] / 1e6
