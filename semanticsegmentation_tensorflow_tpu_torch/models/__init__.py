"""Models of the port: the FCN family, SegNet and DeepLab-ASPP on a VGG16
encoder, NHWC in, float32 NHWC logits out, bf16 compute with f32 params.
Build them with ``models.registry.build_model``. ``models`` imports
``ops``, never the other way."""
