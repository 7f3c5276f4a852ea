"""Host ms to issue one ``decode_step`` (the window's steps)."""

WRAPS = [("repro_torch.models.decode", "decode_step", "pb.decode_step")]


def read(run):
    x = run.spans.host.get("pb.decode_step") if run.spans else None
    return 1e3 * sum(x) / len(x) if x else None
