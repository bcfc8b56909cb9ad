"""The benchmark's harness: one run of one cell (``runner``), which finds
the cell's traffic driver (``portbench/kinds/<kind>.py``), metrics
(``portbench/metrics/<metric>.py``) and reference model
(``portbench/reference/models/<model>.py``) by name; the inputs and
weights it makes from the seed (``inputs``); and the arithmetic
(``work``) and trace reading (``trace``, ``readers``) that the per-layer
metrics use."""
