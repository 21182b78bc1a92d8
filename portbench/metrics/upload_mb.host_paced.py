"""Megabytes a call copies from the host to the card in the dense pass
and the scoring engine (the port's counter h2d_bytes). Averaged over the
completed calls, or over every call where none completed; nothing where
the port has no such counter."""
from portbench import stages


def read(record):
    return stages.per_call(record, "h2d_bytes", scale=1e-6)
