"""Seconds a call spends making the target ORF lists of its two searches
(orf_aa_encoded and the per-ORF list; the port's span target_orfs).
Averaged over the completed calls, or over every call where none
completed; nothing where the port has no such span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "target_orfs")
