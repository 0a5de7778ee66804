"""Device milliseconds of the port's own kernels (csrc/*.cu, by name in
the profiler's trace) a thousand pairs of the window: the sum of their
launches' times."""

from h100_bench.readers import kernel_intervals, per_kpair_ms


def read(run):
    spans = kernel_intervals(run)
    if spans is None:
        return None
    return per_kpair_ms(run, sum(b - a for a, b in spans))
