"""Device busy milliseconds a sort call under Round 1's span
(``phase:round1->2 samples``: SMMS's pair sort, payload gather and
samples; Terasort's Algorithm-S samples), from the program's own spans
in the traced window (``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, False, spantrace.under(
        "phase:round1->2 samples"))
