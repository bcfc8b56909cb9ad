"""aspp_launch_ms.train: the host ms inside the program's ``aspp`` span (the
ASPP-L head's forward: its four branches' launches) per ``step`` span over
the program-traced stretch."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.per_unit_ms(rec, ("aspp",), "step")
