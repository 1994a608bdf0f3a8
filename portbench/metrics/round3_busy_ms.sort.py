"""Device busy milliseconds a sort call under Round 3's span
(``phase:round3 shuffle``: the cut, the send tiles, the all-to-all and
the merge; Terasort's sort too), from the program's own spans in the
traced window (``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, False, spantrace.under(
        "phase:round3 shuffle"))
