"""The card's idle share of the profiled stretch: one minus the union of
its kernel, copy and set intervals over the stretch's wall time."""


def read(run):
    st = run.stretch
    if st is None or st.wall_s <= 0 or not st.ops:
        return None
    return 100.0 * (1.0 - st.busy_s / st.wall_s)
