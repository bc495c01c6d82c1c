"""Seconds from the process's start to the measured window: imports, the
kernels' build (or load from `build/kernels/`), weights, the memory guard
and the cell's first steps or requests (host clock)."""


def read(r):
    return r.setup_s
