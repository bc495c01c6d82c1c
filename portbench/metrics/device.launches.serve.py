"""Device operations (kernels, memcpys, memsets) a request in the traced
segment (torch.profiler)."""


def read(r):
    if r.kind != "serve" or r.trace is None or not r.trace.items:
        return None
    return len(r.trace.device) / r.trace.items
