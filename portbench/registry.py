"""Per-layer metrics the program counts itself: the histograms of its
process-wide metrics registry (``pixie_tpu_torch.services.observability
.default_registry``), which its query tracer (``exec/trace.py``) fills.

A run of ``portbench.run`` is one process that runs one cell, so a
histogram there holds the cell's warm-up queries and every query of its
window, and nothing else. They are read for a run whose profiled stretch
holds device ops: these are the host's intervals of the card's path (the
fold's launches, the hand-off of device windows), and without a card the
same intervals time other work (the fold itself), so a CPU run reports
none of them.
"""


def mean_ms(run, name: str, **labels):
    """The mean observation of histogram ``name`` (seconds), in ms, over
    the label sets that hold ``labels``; None where ``run`` profiled no
    device op, or the program has no such histogram or it holds no
    observation."""
    if run.stretch is None or not run.stretch.ops:
        return None
    from pixie_tpu_torch.services.observability import default_registry

    state = default_registry.histogram_state(name, **labels)
    if state is None:
        return None
    _, _, count, total = state
    if count == 0:
        return None
    return 1e3 * total / count
