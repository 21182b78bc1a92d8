"""Seconds a call spends in the nucleotide re-alignment merge of its two
searches (the port's span nucl_merge). Averaged over the completed
calls, or over every call where none completed; nothing where the port
has no such span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "nucl_merge")
