"""The least bytes a script's work moves, from the configuration alone.

A roofline counts each input byte once and each output byte once,
whatever the implementation reads again: the widths come from the
configuration's columns and the traffic's ``reads``, never from what
the program stages; the result's rows are the reference's.
"""

from __future__ import annotations


def scan_bytes(cfg: dict, traffic: dict, rows: int, result_rows: int) -> int:
    """Every column the script reads, each row once, plus the result
    written once."""
    cols = cfg["columns"]
    return rows * sum(cols[c] for c in traffic["reads"]) + result_rows * int(
        traffic["result_row_bytes"])
