"""Generated tokens completed in the window over the window's seconds
(host clock; a token's time is the end of the step that produced it)."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
