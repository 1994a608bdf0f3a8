"""Device idle milliseconds a sort call while the host is in Round 3's
span (``phase:round3 shuffle``), from the program's own spans in the
traced window (``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, True, spantrace.under(
        "phase:round3 shuffle"))
