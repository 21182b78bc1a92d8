"""Percent of the traced window in which no kernel, copy or memset ran on
the card (1 - the union of their intervals / the window)."""


def read(record):
    if "busy_us" not in record or record["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_us"] * 1e-6 / record["window_s"])
