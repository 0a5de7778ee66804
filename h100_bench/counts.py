"""The program's work counts in a traced run, and stage time over them.

A traced ``superbatch`` span (``rfa/engine.process_barcodes``, one call on
one worker) carries the work that repeats multiply as attributes
(``rfa.engine.WORK_COUNTS``: ``seeds``, ``chains``, ``hits``,
``rescue_attempts``, ``rescue_placed``, ``candidates``), and every stage
span inside it the superbatch's id.  A metric that reads them takes both
from the same superbatches: those whose ``superbatch`` span ends in the
window.  None where the run holds no such counts: no trace, or a program
that does not count.
"""

from __future__ import annotations

from typing import Dict, Optional

from . import spans


def in_window(run) -> Optional[Dict[int, dict]]:
    """{superbatch id: its span} of the superbatches whose span ends in the
    window; None without a trace."""
    found = spans.named(run, ["superbatch"])
    if found is None:
        return None
    lo, hi = run["window"]
    return {s["superbatch"]: s for s in found if lo <= s["end"] <= hi}


def total(run, count: str) -> Optional[int]:
    """The ``count`` summed over the window's superbatches; None where none
    of them carries it."""
    sbs = in_window(run)
    if not sbs:
        return None
    counted = [s["attrs"][count] for s in sbs.values() if count in s["attrs"]]
    return sum(counted) if counted else None


def stage_us_per(run, stage: str, count: str) -> Optional[float]:
    """Thread-microseconds of the TIMERS stage ``stage`` over ``count``,
    both over the window's superbatches; None where the count is missing
    or 0."""
    n = total(run, count)
    if not n:
        return None
    sbs = in_window(run)
    seconds = sum(s["end"] - s["start"] for s in spans.named(run, [stage])
                  if s["superbatch"] in sbs)
    return 1e6 * seconds / n
