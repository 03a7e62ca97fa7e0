"""The least time of a query's work over its device time, as a share.

The least time is the bytes of every column the script reads, each row
once, plus the result written once (``portbench/work.py``), at the
card's published HBM bandwidth (``portbench/peaks.json``). The device
time is the union of the card's intervals in the profiled stretch, per
query in it."""

from portbench.work import scan_bytes


def read(run):
    st = run.stretch
    if st is None or st.queries <= 0 or st.busy_s <= 0 or not run.peak_bytes_per_s:
        return None
    need = scan_bytes(run.cell.config, run.cell.traffic, run.rows, run.result_rows)
    return 100.0 * (need / run.peak_bytes_per_s) / (st.busy_s / st.queries)
