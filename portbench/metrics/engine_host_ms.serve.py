"""Host ms a window step spends in ``ServingEngine.step`` outside its
calls of ``decode_step`` and ``plane.tick`` (admission, token pick,
the argmax's read and its consumption)."""

WRAPS = [("repro_torch.models.decode", "decode_step", "pb.decode_step"),
         ("@plane", "tick", "pb.plane_tick")]


def read(run):
    h = run.spans.host if run.spans else {}
    if not h.get("pb.step"):
        return None
    rest = (sum(h["pb.step"]) - sum(h.get("pb.decode_step", []))
            - sum(h.get("pb.plane_tick", [])))
    return 1e3 * rest / len(h["pb.step"])
