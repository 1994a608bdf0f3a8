"""Device busy milliseconds a sort call under the front door's span
(``cluster.sort``) but outside every ``capacity.attempt``: the output's
collection (``received_objects``' row gathers) and the report, from
the program's own spans in the traced window
(``portbench/spantrace.py``)."""
from portbench import spantrace

UNIT = "ms/call"
spantrace.install()


def read(run):
    return spantrace.per_call_ms(run, False, spantrace.front_door)
