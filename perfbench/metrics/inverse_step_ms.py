"""The window's whole time over the Adam steps completed in it (host
clock), in ms."""


def read(record):
    if record.get("kind") != "inverse" or not record["steps"]:
        return None
    return record["window_s"] / record["steps"] * 1e3
