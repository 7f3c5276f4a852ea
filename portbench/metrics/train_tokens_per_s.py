"""Training tokens of the steps run in the window over its seconds: the
window ends on a synchronisation after its last step."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
