"""Seconds a call spends scoring the candidate pairs of its two
searches: the host engine's batched alignment (span host_align) or the
GPU engine with its E-value screen and survivor alignment (span
card_scoring), whichever ran. Averaged over the completed calls, or over
every call where none completed; nothing where the port has no such
span."""
from portbench import stages


def read(record):
    return stages.per_call(record, "host_align", "card_scoring")
