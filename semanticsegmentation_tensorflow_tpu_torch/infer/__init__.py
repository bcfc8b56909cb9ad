"""Inference of the port: the Predictor (overlay and label maps)."""

from semanticsegmentation_tensorflow_tpu_torch.infer.predict import (  # noqa: F401
    Predictor,
)
