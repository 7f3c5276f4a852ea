"""Decode attention (B3) over the profiled steps: its least time (the K
and V of the positions each slot attends, q and the output, each moved
once at 3.35 TB/s, or its FLOPs at 67 TFLOP/s if longer) over its
measured time, in percent.  The time is the profiler's kernel time
where it saw every launch, else the CUDA events around each call."""


def keep(q, k_cache, v_cache, lengths, *, window=0):
    """What the bound needs of a call: the lengths and the shapes."""
    return (lengths.clone(), k_cache.shape[1], q.shape[1], k_cache.shape[2],
            q.shape[2], int(window), q.element_size(),
            k_cache.element_size())


WRAPS = [("repro_torch.models.attention", "decode_attention", "pb.b3", keep)]


def read(run):
    b3 = run.b3
    if not b3:
        return None
    t = b3["profiled_s"] if b3["profiled_s"] is not None else b3["event_s"]
    return 100.0 * b3["bound_s"] / t if t > 0 else None
