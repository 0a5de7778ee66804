"""The writer's backpressure: the share of the window in which the main
thread was blocked handing a barcode set to the writer's full queue (the
program's `driver.emit_blocked` spans, opened only when a put blocks).
0 in a traced run where no put blocked; None without the program's spans."""

from h100_bench import spans


def read(run):
    blocked = spans.seconds_in_window(run, "driver.emit_blocked")
    if blocked is None:
        return None
    return 100.0 * blocked / run["window_s"]
