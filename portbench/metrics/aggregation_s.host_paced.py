"""Seconds a call spends in besthitperset, mergeresultsbyset and
combinescore, forward and control (the port's span aggregation).
Averaged over the completed calls, or over every call where none
completed; nothing where the port has no such span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "aggregation")
