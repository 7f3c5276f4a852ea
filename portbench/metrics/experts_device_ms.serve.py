"""Device ms a profiled step spends in kernels launched by ``moe_apply``
(router, dispatch, the experts' products, combine, shared expert)."""

WRAPS = [("repro_torch.models.transformer", "moe_apply", "pb.experts")]


def read(run):
    t = run.trace
    s = t.device_s.get("pb.experts", 0.0) if t else 0.0
    return 1e3 * s / run.profiled_steps if s > 0 else None
