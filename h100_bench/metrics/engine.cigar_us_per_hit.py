"""CIGAR finalization's cost a hit: TIMERS stage `cigar` (the one
reg2aln batch of a superbatch) over its jobs (`hits`), in
thread-microseconds, both over the superbatches whose span ends in the
window (counts.py)."""

from h100_bench.counts import stage_us_per


def read(run):
    return stage_us_per(run, "cigar", "hits")
