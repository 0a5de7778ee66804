"""What a per-layer metric reads: one traced run's record, and helpers.

A metric is a file ``metrics/<name>.py`` with ``read(run)`` that returns
a number, or None where the run holds nothing for it to read.  ``run``
is a dict:

  threads       the align workers (-t)
  pairs         read pairs written in the window
  window        (open, close) on the perf_counter clock, seconds
  window_s      close - open
  stages_s      {TIMERS stage: seconds inside the window}, summed over
                threads (thread-seconds, not self time)
  batch_spans   [(start, end)] of every process_barcodes call (a
                superbatch on a worker), perf_counter seconds
  device        None, or {"events": [(name, start, end)] of every device
                activity in perf_counter seconds, "port_kernels": the
                port's kernel names, "kernel_of": event name -> port
                kernel or None}
  global_cells  DP cells of the problems given to BatchGlobal.submit in
                the window (work.band_cells), or None
  card          torch.cuda.get_device_name(), and max_sm_mhz its clock
"""

from __future__ import annotations

from typing import Optional

from . import window


def per_kpair_ms(run, seconds: Optional[float]) -> Optional[float]:
    if seconds is None or not run["pairs"]:
        return None
    return seconds * 1e3 / (run["pairs"] / 1e3)


def stage_ms_per_kpair(run, stage: str) -> Optional[float]:
    """A TIMERS stage's milliseconds a thousand pairs of the window; None
    where the stage never ran in it."""
    return per_kpair_ms(run, run["stages_s"].get(stage))


def kernel_intervals(run, kernel: Optional[str] = None):
    """(start, end) inside the window of every launch of the port's
    kernels, or of the one named; None without a device trace."""
    dev = run["device"]
    if dev is None:
        return None
    lo, hi = run["window"]
    spans = [(a, b) for name, a, b in dev["events"]
             if (k := dev["kernel_of"](name)) is not None and (kernel is None or k == kernel)]
    return window.clip(spans, lo, hi)
