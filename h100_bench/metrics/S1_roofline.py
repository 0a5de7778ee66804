"""Kernel S1 (csrc/seed.cu smem_pass_kernel) against its roofline: the
occ4 rows S1 counted (the `rank_rows` of the program's S1 launch spans
that start in the window), each a 64-byte record read from the card's
HBM at its peak rate (work.PEAKS: the configuration's record table lies
beyond the 50 MB L2), over the device time of S1's launches in the
window.  None without the counts or the device trace."""

from h100_bench import spans, work
from h100_bench.readers import kernel_intervals

ROW_BYTES = 64


def read(run):
    rows = spans.launch_work(run, ["arachne_smem_pass", "arachne_smem_pass_sharded"],
                             "rank_rows")
    times = kernel_intervals(run, "smem_pass_kernel")
    peak = work.PEAKS.get(run["card"])
    if not rows or not times or peak is None:
        return None
    return 100.0 * rows * ROW_BYTES / peak["hbm_bytes_per_s"] / sum(b - a for a, b in times)
