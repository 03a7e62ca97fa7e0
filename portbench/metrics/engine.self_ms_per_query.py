"""The engine's own host time per query: the mean of the program's
``pixie_query_engine_self_seconds`` (each query's wall time less its
compile, the query thread's compute, finalize and materialize, and its
pipeline stall; ``exec/trace.py``), over the run's warm-up queries and
every query of its window. None where the program has no such
histogram.
Read in a traced run on a card only (``portbench/registry.py``)."""

from portbench.registry import mean_ms


def read(run):
    return mean_ms(run, "pixie_query_engine_self_seconds")
