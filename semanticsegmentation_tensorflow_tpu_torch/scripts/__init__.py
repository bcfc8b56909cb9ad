"""Entry points of the port, run as
``python -m semanticsegmentation_tensorflow_tpu_torch.scripts.<name>``."""
