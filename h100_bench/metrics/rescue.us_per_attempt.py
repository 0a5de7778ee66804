"""Mate rescue's cost an attempt: TIMERS stage `rescue` (both waves of a
superbatch) over its SW windows, batched and replayed on the host
(`rescue_attempts`), in thread-microseconds, both over the superbatches
whose span ends in the window (counts.py)."""

from h100_bench.counts import stage_us_per


def read(run):
    return stage_us_per(run, "rescue", "rescue_attempts")
