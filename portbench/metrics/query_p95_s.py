"""The 95th percentile of every query of the window, each timed on the
host clock from ``execute_query`` to its answer on the host."""

import numpy as np


def read(run):
    if not run.query_s:
        return None
    return float(np.percentile(run.query_s, 95))
