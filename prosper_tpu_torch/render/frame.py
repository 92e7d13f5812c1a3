"""Render modes: mode name -> frame call.

Counterpart of prosper_tpu/render/frame.py `render_modes`: each mode is
a function f(*, scene, cam, lut, width, height, device, state, ...) ->
(image, state), each with its own options. The port has all four modes
of the JAX package: forward (`_forward_entry`, frame.py:16-41; its
debug draw types included), the path tracer, the deferred renderer and
ReSTIR DI. app/cli.py calls them, each with the options it has.
"""

from __future__ import annotations

from .deferred import deferred_entry
from .forward import forward_entry
from .pt import pt_entry
from .restir import restir_entry


def render_modes() -> dict:
    return {"forward": forward_entry, "pt": pt_entry,
            "deferred": deferred_entry, "restir": restir_entry}
