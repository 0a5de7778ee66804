"""The writer thread on the CPU while it writes: thread CPU seconds over
wall seconds of the program's `io.write` stages (the bam-writer thread's
dump of one barcode set), a span that crosses an end of the window
prorated."""

from h100_bench import spans


def read(run):
    return spans.on_cpu_pct(run, "io.write")
