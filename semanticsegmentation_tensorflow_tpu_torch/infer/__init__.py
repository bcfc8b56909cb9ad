"""Inference of the port: the Predictor (overlay, label and confidence maps),
the test-set sweep, tiled native-resolution inference and test-time
augmentation."""

from semanticsegmentation_tensorflow_tpu_torch.infer.predict import (  # noqa: F401
    Predictor, save_inference_samples,
)
from semanticsegmentation_tensorflow_tpu_torch.infer.window import (  # noqa: F401
    TiledPredictor, tile_offsets,
)
