"""The device memory allocated at its peak over the window
(`torch.cuda.max_memory_allocated`, GiB)."""


def read(r):
    if r.kind != "train" or r.peak_window_bytes is None:
        return None
    return r.peak_window_bytes / 2**30
