"""loader_wait_ms.train: the mean time a step of the traced window waited
on ``BatchLoader.epoch()``'s ``next()`` (the benchmark's host span)."""

from portbench.harness.readers import span_mean_ms


def read(rec):
    return span_mean_ms(rec, "loader_wait")
