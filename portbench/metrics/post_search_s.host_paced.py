"""Seconds a call spends outside both searches: forward aggregation, the
FDR cut, offsets, convert, PAM and the report text (the call's wall less
the `search` and `search_rev` stage timers). Averaged over the completed
calls, or over every call where none completed."""


def read(record):
    calls = [c for c in record["calls"] if c["ok"]] or record["calls"]
    if not calls:
        return None
    rest = [c["wall_s"] - c["stages"].get("search", 0.0)
            - c["stages"].get("search_rev", 0.0) for c in calls]
    return sum(rest) / len(rest)
