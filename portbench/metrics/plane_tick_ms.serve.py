"""Host ms of one ``MemoryPlane.tick`` (monitor, controller flush, pool
actuation), every tick of the window over their count."""

WRAPS = [("@plane", "tick", "pb.plane_tick")]


def read(run):
    x = run.spans.host.get("pb.plane_tick") if run.spans else None
    return 1e3 * sum(x) / len(x) if x else None
