"""The median over the window's requests of the harness's span around the
encoder's call, synchronised at both ends (host clock, ms)."""

import statistics


def read(r):
    spans = r.spans.get("encoder")
    return statistics.median(spans) * 1e3 if spans else None
