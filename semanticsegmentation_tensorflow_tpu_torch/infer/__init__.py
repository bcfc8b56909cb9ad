"""Inference of the port: the Predictor (overlay, label and confidence maps)
and the test-set sweep."""

from semanticsegmentation_tensorflow_tpu_torch.infer.predict import (  # noqa: F401
    Predictor, save_inference_samples,
)
