"""The query thread's wait on the window pipeline's prefetch thread, per
query: the mean of the program's ``pixie_pipeline_stall_seconds`` (one
observation per query, from ``exec/pipeline.py``'s ``stall_secs``),
over the run's warm-up queries and every query of its window.
Read in a traced run on a card only (``portbench/registry.py``)."""

from portbench.registry import mean_ms


def read(run):
    return mean_ms(run, "pixie_pipeline_stall_seconds")
