"""launch_idle_pct.train: the share of the program-traced stretch's
device-only profiler session (its last steps) in which the device idled
while the main thread was inside the program's ``step`` span or its
children, in % of the session's wall."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.idle_pct_under(rec, ("step",))
