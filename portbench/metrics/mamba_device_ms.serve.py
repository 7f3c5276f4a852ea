"""Device ms a profiled step spends in kernels launched by
``mamba_decode_step`` (the hybrid layers' recurrent branch)."""

WRAPS = [("repro_torch.models.decode", "mamba_decode_step", "pb.mamba")]


def read(run):
    t = run.trace
    s = t.device_s.get("pb.mamba", 0.0) if t else 0.0
    return 1e3 * s / run.profiled_steps if s > 0 else None
