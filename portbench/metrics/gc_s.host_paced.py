"""Seconds a call spends in Python's garbage collector (gc.callbacks
registered by the benchmark around the window). Averaged over the
completed calls, or over every call where none completed."""


def read(record):
    calls = [c for c in record["calls"] if c["ok"]] or record["calls"]
    if not calls:
        return None
    return sum(c["gc_s"] for c in calls) / len(calls)
