"""Multi-rank training (counterpart of the JAX package's ``parallel/``): the
data x spatial grid of process groups (``mesh``), the process-group launch
(``launch``) and the row halo exchange that height partitioning needs
(``halo``)."""
