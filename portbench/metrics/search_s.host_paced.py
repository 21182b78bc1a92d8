"""Seconds a call spends in the forward search (the port's `search` stage
timer, logging.timings(), differenced across each call). Averaged over
the completed calls, or over every call where none completed."""


def read(record):
    calls = [c for c in record["calls"] if c["ok"]] or record["calls"]
    if not calls:
        return None
    return sum(c["stages"].get("search", 0.0) for c in calls) / len(calls)
