"""Device kernels launched in the profiled stretch, per query in it."""


def read(run):
    st = run.stretch
    if st is None or st.queries <= 0:
        return None
    n = len(st.kernels())
    return n / st.queries if n else None
