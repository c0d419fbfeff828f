"""picture_latency_ms.p90 (ms; frame ring): the 90th percentile of the
window's picture latencies (statistics.quantiles, n=10)."""

import statistics


def read(run):
    lat = run.window.latencies
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10)[8]
