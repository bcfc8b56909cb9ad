"""frame_p95_ms: the 95th percentile of every request's latency in the
window (the call with a host frame to the host holding its overlay and
labels), by ``statistics.quantiles``."""

import statistics


def read(rec):
    lat = rec["window"]["latencies"]
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
