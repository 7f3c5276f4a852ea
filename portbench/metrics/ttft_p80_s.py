"""80th percentile, over every request whose first token comes in the
window, of the seconds from its submission to that token (host clock).
The first request of each client, cut to stand for one under way, is
not one of the mix's and is left out."""

import numpy as np


def read(run):
    x = [r.t_first - r.t_submit for r in run.recs
         if not r.first_wave and run.in_window(r.t_first)]
    return float(np.percentile(x, 80)) if x else None
