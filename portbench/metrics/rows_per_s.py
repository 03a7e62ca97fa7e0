"""Rows scanned by every query of the window, over the window's time
(host clock, from the first query's start to the last one's answer)."""


def read(run):
    if not run.query_s or run.window_s <= 0:
        return None
    return run.rows * len(run.query_s) / run.window_s
