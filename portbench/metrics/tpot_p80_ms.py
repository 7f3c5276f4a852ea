"""80th percentile, over every request completed in the window with at
least 5 tokens, of its milliseconds per output token after the first:
(last token - first token) / (tokens - 1), host clock, a requeue after
preemption included; each spans at least 4 steps."""

import numpy as np


def read(run):
    x = [1e3 * (r.t_last - r.t_first) / (r.n_out - 1) for r in run.recs
         if run.in_window(r.t_done) and r.n_out >= 5]
    return float(np.percentile(x, 80)) if x else None
