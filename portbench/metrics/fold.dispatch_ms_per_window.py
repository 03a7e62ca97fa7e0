"""The host's time issuing one window's fold, unfenced: the mean of the
program's ``pixie_window_stage_seconds{stage="compute"}`` (one
observation per window folded, stamped by ``exec/stream.py``
``_timed``), over the run's warm-up queries and every query of its
window.
Read in a traced run on a card only (``portbench/registry.py``)."""

from portbench.registry import mean_ms


def read(run):
    return mean_ms(run, "pixie_window_stage_seconds", stage="compute")
