"""The device's idle share of a request, in %: 1 - (the union of the
card's kernel, memcpy and memset intervals a request in the traced
segment) / (the measured window's host-clock seconds a request).  The
divisor is the untraced window's, since the profiler stretches the
traced segment's host time; user annotations are not device work."""


def read(r):
    if (r.kind != "serve" or r.trace is None or not r.trace.items
            or not r.items):
        return None
    busy = r.trace.busy_s / r.trace.items
    return 100.0 * (1.0 - busy / (r.window_s / r.items))
