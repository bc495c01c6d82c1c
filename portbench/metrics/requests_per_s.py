"""Requests completed in the window over its seconds (one closed-loop
client; host clock)."""


def read(r):
    return r.items / r.window_s if r.kind == "serve" else None
