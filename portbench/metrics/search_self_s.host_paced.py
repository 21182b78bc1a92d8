"""Seconds of a call's two searches that no child span of search_setdbs
covers (the span's self time): what the search spans leave unattributed.
Averaged over the completed calls, or over every call where none
completed; nothing where the port has no such span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "search_setdbs.self")
