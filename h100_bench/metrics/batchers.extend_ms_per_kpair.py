"""TIMERS stage `extend.device`: thread-milliseconds a thousand pairs of the window."""

from h100_bench.readers import stage_ms_per_kpair


def read(run):
    return stage_ms_per_kpair(run, "extend.device")
