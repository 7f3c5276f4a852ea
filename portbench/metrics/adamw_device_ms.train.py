"""Device ms a profiled step spends in kernels of ``adamw_update``."""

WRAPS = [("repro_torch.train.step", "adamw_update", "pb.adamw")]


def read(run):
    t = run.trace
    s = t.device_s.get("pb.adamw", 0.0) if t else 0.0
    return 1e3 * s / run.profiled_steps if s > 0 else None
