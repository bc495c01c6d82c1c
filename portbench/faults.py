"""Faults planted in the program underneath the timed path, which the
check has to catch (`tests/test_portbench_check.py`, `calibrate.py`):

  * `half_batch`: the loss and its gradient over the first half of each
    batch's rows, the mean taken over them;
  * `unchanged_state`: the optimizer's update does nothing;
  * `altered_render` (serving): the render comes back upside down where
    `decode_splatting` produces it;
  * `altered_opacities` (serving): the Gaussians' opacities come back 5%
    low where the encoder's opacity mapping (`map_pdf_to_opacity`, as
    `models/encoder_base.py` calls it) produces them;
  * `altered_loss` (training): the MSE term comes back 5% high where
    `compute_losses` takes it.  (A render altered inside a training step
    is not caught: against seeded pixels, an unrelated render's loss does
    not depend on which unrelated render it is; PERF.md section 7.)
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib

PORT = "spfsplatv2_tpu_torch"


def half_rows(b: dict) -> dict:
    n = b["context"]["image"].shape[0] // 2
    return {part: ({k: t[:n] for k, t in views.items()}
                   if part in ("context", "target") else views)
            for part, views in b.items()}


@contextlib.contextmanager
def patched(module: str, name: str, make):
    mod = importlib.import_module(f"{PORT}.{module}")
    orig = getattr(mod, name)
    setattr(mod, name, make(orig))
    try:
        yield
    finally:
        setattr(mod, name, orig)


def half_batch():
    def make(orig):
        return lambda encoder, batch, *a, **k: orig(encoder, half_rows(batch),
                                                    *a, **k)
    return patched("training.step", "compute_losses", make)


def unchanged_state():
    return patched("training.optim", "Optimizer", lambda orig: type(
        "Unchanged", (orig,), {"step": lambda self: False}))


def altered_render():
    def make(orig):
        def decode(*a, **k):
            out = orig(*a, **k)
            return dataclasses.replace(out, color=out.color.flip(-3))
        return decode
    return patched("models.decoder", "decode_splatting", make)


def altered_opacities():
    def make(orig):
        return lambda *a, **k: 0.95 * orig(*a, **k)
    return patched("models.encoder_base", "map_pdf_to_opacity", make)


def altered_loss():
    def make(orig):
        return lambda *a, **k: 1.05 * orig(*a, **k)
    return patched("training.step", "mse_loss", make)


FAULTS = {"half_batch": half_batch, "unchanged_state": unchanged_state,
          "altered_render": altered_render,
          "altered_opacities": altered_opacities, "altered_loss": altered_loss}
