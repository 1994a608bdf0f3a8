"""Share of the sort calls' wall time spent in capacity attempts that
dropped objects (every ``capacity.attempt`` span of a call but its
last: the retry loop stops at the first attempt that drops none), over
the calls' wall time, in the traced window (``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "%"
spantrace.install()


def read(run):
    st = spantrace.spans_of(run)
    if st is None or st.call_wall_s <= 0:
        return None
    return 100.0 * st.dropped_wall_s / st.call_wall_s
