"""step_syncs.train: the host-device synchronizations that torch reports
(``torch.cuda.set_sync_debug_mode``) inside the program's ``step`` span and
its children, per step, over the program-traced stretch."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.syncs_per(rec, "step")
