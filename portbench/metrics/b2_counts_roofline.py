"""B2 counts' share of its bound: 2 x 128 int8 operations per dense cell
(a query k-mer row that can match x a target position) over 1,979 TOP/s,
against the device time of counts_kernel. The rows are counted from the
window's batches by the reference's own row rule, the positions are the
masked target of each search, so any implementation reads the same
work."""
from portbench import roofline
from portbench.reference import seqs


def read(record):
    ops = 0
    for c in record["calls"]:
        rows = seqs.rows_that_can_match(c["batch"])
        ops += sum(rows * t_res for _, t_res in c["searches"])
    return roofline.share(record, ops * roofline.B2_OPS_PER_CELL, "int8_ops",
                          ["counts_kernel"])
