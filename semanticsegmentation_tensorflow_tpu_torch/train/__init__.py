"""Training of the port: loss, metrics, optimizer state, the train step, the
loop and checkpoints (counterparts of the JAX package's ``train/``)."""
