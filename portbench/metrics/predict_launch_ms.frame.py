"""predict_launch_ms.frame: the host time a request spends in the
Predictor's ``predict.forward`` (normalize, pad, the model's forward) and
``predict.overlay`` (kernel 2) spans, over the program-traced stretch, in
ms a request."""

from portbench.harness import program_trace


def read(rec):
    return program_trace.per_unit_ms(rec, ("predict.forward", "predict.overlay"),
                                     "predict")
