"""The 90th percentile of every request's latency in the window: from the
request's send (its views still on the host) to its Gaussians, poses and
render synchronised on the device (host clock, ms)."""

import statistics


def read(r):
    if r.kind != "serve" or len(r.latencies_s) < 2:
        return None
    return statistics.quantiles(r.latencies_s, n=10,
                                method="inclusive")[8] * 1e3
