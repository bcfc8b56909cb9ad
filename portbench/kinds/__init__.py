"""Traffic drivers, one file each: ``portbench/kinds/<kind>.py`` gives the
``Mix`` that a mix file of ``"kind": "<kind>"`` drives (see
``harness/runner.py`` for what a run asks of it)."""
