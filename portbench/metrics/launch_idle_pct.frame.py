"""launch_idle_pct.frame: the share of the program-traced stretch's
device-only profiler session (its last requests) in which the device idled
while the main thread was inside the Predictor's ``predict.forward`` or
``predict.overlay`` span, in % of the session's wall."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.idle_pct_under(rec, ("predict.forward", "predict.overlay"))
