"""Garbage-collection pauses per query: the mean of the program's
``pixie_query_gc_seconds`` (the collections on the query's threads,
timed by its ``gc.callbacks`` hook; ``exec/trace.py``), over the run's
warm-up queries and every query of its window; 0 where none collected.
None where the program has no such histogram.
Read in a traced run on a card only (``portbench/registry.py``)."""

from portbench.registry import mean_ms


def read(run):
    return mean_ms(run, "pixie_query_gc_seconds")
