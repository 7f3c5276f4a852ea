"""Percent of the profiled window in which no operation ran on the
device (B3's event-timed seconds added to busy where the profiler
missed its launches)."""

from portbench.harness import metric

WRAPS = metric("b3_roofline").WRAPS      # its events, where the profiler
                                         # missed B3's launches


def read(run):
    t = run.trace
    if not t or t.busy_s <= 0:
        return None
    busy = t.busy_s
    if run.b3 and run.b3["profiled_s"] is None:
        busy += run.b3["event_s"]
    return 100.0 * (1.0 - busy / t.window_s)
