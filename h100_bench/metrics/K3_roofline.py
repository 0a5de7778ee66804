"""Kernel K3 (csrc/global.cu global_kernel, score and z) against its
roofline: the band cells of every problem given to BatchGlobal.submit in
the window, each counted once at work.OPS_PER_CELL integer instructions,
at the card's peak integer rate (work.PEAKS, the maximum SM clock read in
the run), over the device time of every K3 launch in the window.  None
where K3 did not run in the window."""

from h100_bench import work
from h100_bench.readers import kernel_intervals


def read(run):
    spans = kernel_intervals(run, "global_kernel")
    if not spans or not run["global_cells"]:
        return None
    t = work.bound_s(run["global_cells"] * work.OPS_PER_CELL, run["card"], run["max_sm_mhz"])
    if t is None:
        return None
    return 100.0 * t / sum(b - a for a, b in spans)
