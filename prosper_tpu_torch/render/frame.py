"""Render modes: mode name -> frame call.

Counterpart of prosper_tpu/render/frame.py `render_modes`: each mode is
a function f(*, scene, cam, lut, width, height, device, state, ...) ->
(image, state) (the path tracer also takes its own options). The port
has the path tracer and the deferred renderer; forward, ReSTIR and the
debug views wait for their ROADMAP.md items.
"""

from __future__ import annotations

from .deferred import deferred_entry
from .pt import pt_entry


def render_modes() -> dict:
    return {"pt": pt_entry, "deferred": deferred_entry}
