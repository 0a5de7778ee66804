"""The RFA tail's cost a candidate: TIMERS stage `rfa.host` over the
alignments entering the tail (`candidates`), in thread-microseconds, both
over the superbatches whose span ends in the window (counts.py)."""

from h100_bench.counts import stage_us_per


def read(run):
    return stage_us_per(run, "rfa.host", "candidates")
