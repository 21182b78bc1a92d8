"""Seconds a call spends in the control search and its aggregation (the
port's `search_rev` stage timer, differenced across each call). Averaged
over the completed calls, or over every call where none completed."""


def read(record):
    calls = [c for c in record["calls"] if c["ok"]] or record["calls"]
    if not calls:
        return None
    return sum(c["stages"].get("search_rev", 0.0) for c in calls) / len(calls)
