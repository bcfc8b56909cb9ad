"""Models of the port: the FCN family on a VGG16 backbone, NHWC in, float32
NHWC logits out, bf16 compute with f32 params. Build them with
``models.registry.build_model``. (No imports here: ``ops`` modules import
``models.common``, and ``models.fcn8s`` imports ``ops``.)"""
