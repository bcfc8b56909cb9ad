"""device_idle.train: 1 - busy / wall over the device-only profiler session
of the traced run's last steps, in %."""

from portbench.harness.readers import device_idle_pct


def read(rec):
    return device_idle_pct(rec)
