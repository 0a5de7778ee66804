"""The share of the window in which no operation runs on the card: one
minus the union of every device activity's interval (kernels and
copies) over the window."""

from h100_bench import window


def read(run):
    dev = run["device"]
    if dev is None:
        return None
    lo, hi = run["window"]
    busy = window.covered([(a, b) for _, a, b in dev["events"]], lo, hi)
    return 100.0 * (1.0 - busy / (hi - lo))
