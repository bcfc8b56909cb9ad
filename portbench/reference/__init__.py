"""The plain float32 reference that decides ``correct``: the models, one
file each (``models``), the layers they are built of (``layers``), the
training steps (``train``) and the served frame's logits and overlay
(``predict``). Imports torch and numpy only: nothing of the measured
program and nothing of JAX."""
