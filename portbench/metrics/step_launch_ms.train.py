"""step_launch_ms.train: the mean host time of the program's ``step`` span
(the train step's call, from augment to the optimizer's update and EMA)
over the program-traced stretch, in ms."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.mean_ms(rec, "step")
