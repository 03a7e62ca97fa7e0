"""The mean duration of the engine tracer's ``compile`` span (the PxL
compile inside ``Engine.execute_query``) over the queries of the
profiled stretch."""


def read(run):
    if not run.compile_ms:
        return None
    return sum(run.compile_ms) / len(run.compile_ms)
