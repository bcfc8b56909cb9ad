"""Inference of the port: the Predictor (overlay, label and confidence maps),
the test-set sweep, tiled native-resolution inference, test-time
augmentation, and serving artifacts (``export_model``, ``ExportedPredictor``).
"""

from semanticsegmentation_tensorflow_tpu_torch.infer.export import (  # noqa: F401
    ExportedPredictor, export_model,
)
from semanticsegmentation_tensorflow_tpu_torch.infer.predict import (  # noqa: F401
    Predictor, save_inference_samples,
)
from semanticsegmentation_tensorflow_tpu_torch.infer.window import (  # noqa: F401
    TiledPredictor, tile_offsets,
)
