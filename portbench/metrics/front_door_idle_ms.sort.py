"""Device idle milliseconds a sort call while the host is in the front
door's span (``cluster.sort``) but outside every ``capacity.attempt``
(the input's checks, the output's collection, the report), from the
program's own spans in the traced window
(``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, True, spantrace.front_door)
