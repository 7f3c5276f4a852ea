"""Process start to the first timed step: the model drawn from the seed,
the kernels loaded (built in a checkout's first run), the warm-up."""


def read(run):
    return run.setup_s
