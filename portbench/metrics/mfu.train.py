"""Useful FLOPs of the window's steps (3 x the forward's: the dense
products of the routed experts only, causal attention; portbench/
yardstick.py) over the window's seconds times 67 TFLOP/s, the H100's
float32 peak, in percent."""

from portbench.yardstick import PEAK_F32, train_step_flops


def read(run):
    if not run.steps or run.window_s <= 0 or not run.on_card:
        return None
    flops = run.steps * train_step_flops(run.arch, run.batch, run.seq_len)
    return 100.0 * flops / (run.window_s * PEAK_F32)
