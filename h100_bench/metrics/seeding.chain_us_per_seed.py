"""Chaining's cost a seed: TIMERS stage `chain.host` over the seed
occurrences entering the chainer (`seeds`), in thread-microseconds, both
over the superbatches whose span ends in the window (counts.py)."""

from h100_bench.counts import stage_us_per


def read(run):
    return stage_us_per(run, "chain.host", "seeds")
