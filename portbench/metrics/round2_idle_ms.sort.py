"""Device idle milliseconds a sort call while the host is in Round 2's
span (``phase:round2 boundaries``: Algorithm 1's small ops, or
Terasort's sample pick), from the program's own spans in the traced
window (``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, True, spantrace.under(
        "phase:round2 boundaries"))
