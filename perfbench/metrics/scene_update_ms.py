"""Host time of the program's own `ct.scene.update` spans
(`RenderSession.update_scene`: compile and copy of a frame's scene into
the session's tables), mean per frame over the profiled frames, in ms.
A program without the span has nothing to read."""


def read(record):
    values = record.get("scene_update_s")
    if not values:
        return None
    return sum(values) / len(values) * 1e3
