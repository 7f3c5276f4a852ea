"""ScenarioLab on PyTorch: scenarios, the fused sweep, scoring, tuning.

Import the entry points from their modules (``lab.sweep``,
``lab.fused_sweep``, ``lab.tune``): this package module imports none of
them, so the kernel module can read ``lab.score`` without a cycle.
"""
