"""The driver's FASTQ parsing and barcode grouping: the program's
`driver.parse` spans (each `next()` of the barcode-set stream on the main
thread) inside the window, milliseconds a thousand pairs of it."""

from h100_bench import spans
from h100_bench.readers import per_kpair_ms


def read(run):
    if not spans.named(run, ["driver.parse"]):
        return None
    return per_kpair_ms(run, spans.seconds_in_window(run, "driver.parse"))
