"""The superbatch scheduler's workers: the share of -t x the window that
process_barcodes calls (one superbatch on one worker) cover."""

from h100_bench import window


def read(run):
    lo, hi = run["window"]
    return 100.0 * window.busy_share(run["batch_spans"], run["threads"], lo, hi)
