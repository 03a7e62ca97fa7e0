"""Seconds from the start of the run to its first timed query: imports,
data generation, the append (ingest sketches and staging included), the
kernels' build where missing, and the warm-up."""


def read(run):
    return run.setup_s
