"""Host time from the render call's entry to the return of its last
`render_chunk` call, mean per frame (the harness's spans), in ms."""


def read(record):
    values = record.get("dispatch_s")
    if not values:
        return None
    return sum(values) / len(values) * 1e3
