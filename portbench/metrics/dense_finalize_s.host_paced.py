"""Seconds a call spends in the dense route's batch finalize (the native
C dup filter, ungapped rescore and max_seqs cut; the port's span
dense_finalize), both searches. Averaged over the completed calls, or
over every call where none completed; nothing where the port has no such
span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "dense_finalize")
