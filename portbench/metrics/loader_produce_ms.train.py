"""loader_produce_ms.train: the mean time of the program's ``loader.produce``
span (``BatchLoader``'s producer thread: one batch's pad, stack and pin)
over the program-traced stretch, in ms."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.mean_ms(rec, "loader.produce")
