"""Device ms a profiled step spends in kernels of ``moe_apply``: its
forward, its recomputation, and (by autograd's sequence numbers) the
backward of its operations."""

WRAPS = [("repro_torch.models.transformer", "moe_apply", "pb.experts")]


def read(run):
    t = run.trace
    s = t.device_s.get("pb.experts", 0.0) if t else 0.0
    return 1e3 * s / run.profiled_steps if s > 0 else None
