"""predict_fetch_ms.frame: the host time a request spends in the Predictor's
``predict.fetch`` span (the wait for the device and the copy of the overlay
and labels to the host), over the program-traced stretch, in ms a
request."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.per_unit_ms(rec, ("predict.fetch",), "predict")
