"""Seconds a call spends in the dense prefilter's whole pass of its two
searches, on the host's clock (the port's span dense_pass around
device_prefilter_arrays: query batch, counts and emit, the stream
rebuild, the batch finalize). Averaged over the completed calls, or over
every call where none completed; nothing where the port has no such
span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "dense_pass")
