"""Kernel K1 (csrc/extend.cu extend_kernel, the main path's int32 form)
against its roofline: the DP cells K1 counted (the `cells` of the
program's `arachne_extend` launch spans that start in the window; the
in-band cells of every row a problem reaches before its early stop), at
work.OPS_PER_CELL integer instructions each, at the card's peak integer
rate (work.PEAKS, the maximum SM clock read in the run), over the device
time of K1's launches in the window.  None without the counts or the
device trace."""

from h100_bench import spans, work
from h100_bench.readers import kernel_intervals


def read(run):
    cells = spans.launch_work(run, ["arachne_extend"], "cells")
    times = kernel_intervals(run, "extend_kernel")
    if not cells or not times:
        return None
    t = work.bound_s(cells * work.OPS_PER_CELL, run["card"], run["max_sm_mhz"])
    if t is None:
        return None
    return 100.0 * t / sum(b - a for a, b in times)
