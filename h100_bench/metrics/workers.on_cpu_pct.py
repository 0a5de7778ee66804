"""The superbatch workers on the CPU: thread CPU seconds over wall seconds
of the program's `superbatch` spans (one process_barcodes call on a
worker), a span that crosses an end of the window prorated.  What the
rest of the span's wall time went to is waiting: the interpreter lock,
another lock, or the card."""

from h100_bench import spans


def read(run):
    return spans.on_cpu_pct(run, "superbatch")
