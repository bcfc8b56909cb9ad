"""device_idle.frame: 1 - busy / wall over the device-only profiler session
of the traced run's last requests, in %."""

from portbench.harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
