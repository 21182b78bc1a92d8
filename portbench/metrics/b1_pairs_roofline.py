"""B1 pairs' share of its bound: 6 int32 operations per true SW cell (query
length x target length over every candidate pair of the dense
prefilter, read from the port's candidate arrays) over 132 SMs x 64
lanes x 1.98 GHz, against the device time of pair_keys_kernel and
sw_pairs_kernel. A run whose card scored no pair reads nothing."""
from portbench import roofline


def read(record):
    return roofline.share(record,
                          record["pair_cells"] * roofline.SW_OPS_PER_CELL,
                          "int32_lane_ops",
                          ["pair_keys_kernel", "sw_pairs_kernel"])
