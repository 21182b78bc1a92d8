"""Peaks of the card and the work that a kernel's roofline share counts.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): int8 tensor-core operations and, for the SW kernels' int32 lanes,
132 SMs x 64 int32 lanes x the 1.98 GHz boost clock.
"""
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(int8_ops=1979e12,
                                  int32_lane_ops=132 * 64 * 1.98e9,
                                  hbm_bytes=3.35e12),
}
# B2 counts: a dense cell (a query k-mer row that can match x a target
# position) is a 128-wide int8 dot product, 2 operations per element
B2_OPS_PER_CELL = 2 * 128
# the SW recurrence: 6 int32 operations per true DP cell
SW_OPS_PER_CELL = 6


def device_seconds(kernels: dict, names) -> float:
    """Summed device seconds of the kernels whose name holds any of
    `names` (kernels: {name: microseconds})."""
    return sum(us for n, us in kernels.items()
               if any(k in n for k in names)) * 1e-6


def share(record: dict, work_ops: float, peak: str, names):
    """100 x (work at the peak) / the kernels' device time, or None where
    the run holds no device time of them or no peak of its card."""
    peaks = PEAKS.get(record.get("device_kind"))
    t = device_seconds(record.get("kernels", {}), names)
    if not peaks or t <= 0 or not work_ops:
        return None
    return 100.0 * (work_ops / peaks[peak]) / t
