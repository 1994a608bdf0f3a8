"""Blocking host reads a sort call: the program's ``sync:<site>``
spans in the traced window over its calls (``portbench/spantrace.py``);
each is a point where the host waits for the card to catch up."""
from portbench import spantrace

UNIT = "syncs/call"
spantrace.install()


def read(run):
    st = spantrace.spans_of(run)
    return None if st is None else st.syncs / st.calls
