"""``output_tokens_per_s`` read in a traced run, for a cell whose step
the host paces so that the rate moves from run to run by more than an
end-to-end bound may hold (see ``PERF.md`` §2).  The traced window
carries the spans' cost as well."""

from portbench.harness import reader


def read(run):
    return reader("output_tokens_per_s")(run)
