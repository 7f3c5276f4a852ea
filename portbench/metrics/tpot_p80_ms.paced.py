"""``tpot_p80_ms`` read in a traced run, for a cell whose step the host
paces so that the time per token moves from run to run by more than an
end-to-end bound may hold (see ``PERF.md`` §2).  The traced window
carries the spans' cost as well."""

from portbench.harness import reader


def read(run):
    return reader("tpot_p80_ms")(run)
