"""Host time in `Film.save_png`, mean per frame (the harness's span), in
ms. Frames that write no PNG have nothing to read."""


def read(record):
    values = record.get("png_s")
    if not values:
        return None
    return sum(values) / len(values) * 1e3
