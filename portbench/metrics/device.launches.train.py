"""Device operations (kernels, memcpys, memsets) a step in the traced
segment (torch.profiler)."""


def read(r):
    if r.kind != "train" or r.trace is None or not r.trace.items:
        return None
    return len(r.trace.device) / r.trace.items
