"""Training samples completed in the window over its seconds (host clock;
the window ends with the step that passes `--seconds`)."""


def read(r):
    return r.samples / r.window_s if r.kind == "train" else None
