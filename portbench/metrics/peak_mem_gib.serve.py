"""GiB of the allocator's peak over the window (reset at its start)."""


def read(run):
    return run.peak_window_bytes / 2 ** 30 if run.on_card else None
