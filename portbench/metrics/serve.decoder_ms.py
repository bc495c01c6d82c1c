"""The median over the window's requests of the harness's span around
`decode_splatting`, synchronised at both ends (host clock, ms)."""

import statistics


def read(r):
    spans = r.spans.get("decoder")
    return statistics.median(spans) * 1e3 if spans else None
