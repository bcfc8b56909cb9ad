"""loader_get_ms.train: the mean time of the program's ``loader.get`` span
(``BatchLoader.epoch()``'s consumer: the wait on the producer's queue and
the side-stream copy it issues) over the program-traced stretch, in ms."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.mean_ms(rec, "loader.get")
