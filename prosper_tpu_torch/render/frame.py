"""Render modes: mode name -> frame call.

Counterpart of prosper_tpu/render/frame.py `render_modes`: each mode is
a function f(*, scene, cam, lut, width, height, device, state, ...) ->
(image, state), each with its own options. The port has the forward
mode (`_forward_entry`, frame.py:16-41; its debug draw types included),
the path tracer and the deferred renderer; ReSTIR waits for its
ROADMAP.md item.
"""

from __future__ import annotations

from .deferred import deferred_entry
from .forward import forward_entry
from .pt import pt_entry


def render_modes() -> dict:
    return {"forward": forward_entry, "pt": pt_entry,
            "deferred": deferred_entry}
