"""Useful model FLOPs of the tokens fed in the window (each token's
dense and attention FLOPs, only its routed experts; portbench/
yardstick.py) over the window's seconds times 67 TFLOP/s, the H100's
float32 peak, in percent."""

from portbench.yardstick import PEAK_F32, serve_window_flops


def read(run):
    if not run.fed or run.window_s <= 0 or not run.on_card:
        return None
    return 100.0 * serve_window_flops(run) / (run.window_s * PEAK_F32)
