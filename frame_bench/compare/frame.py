"""The comparison of frames that stand alone (deferred): each compared
frame's displayed image against the reference's display transform of
the same frame's linear colour, and the frame's own count. The numbers,
each the largest over the compared frames:

- pixels_off: the share of pixels whose displayed value (in [0, 1])
  differs from the reference's by more than display_atol in some
  channel, or is not finite;
- count_off: |count - reference count| / reference count of the frame's
  own count (meshlets drawn).
"""

from __future__ import annotations

import torch

from frame_bench.ref import shade

NUMBERS = ("pixels_off", "count_off")


def keep(prev_state, image, state, stat) -> dict:
    """What the comparison keeps of one frame: its image and its count
    (references, no copies)."""
    return {"image": image, "stat": stat}


def numbers(port: dict, ref_color: torch.Tensor, ref_count: int,
            lut: torch.Tensor, chk: dict) -> dict:
    """port: a kept frame on the reference's device."""
    shown = shade.tone_map(ref_color, lut)
    img = port["image"]
    bad = (((img - shown).abs() > chk["display_atol"]).any(-1)
           | ~torch.isfinite(img).all(-1))
    return {
        "pixels_off": float(bad.float().mean()),
        "count_off": abs(float(port["stat"]) - ref_count) / max(ref_count, 1),
    }


def control(port: dict, color, count, lut, dtype) -> dict:
    """A kept frame as the control would have made it: the control's
    colour shown by the display transform in `dtype`."""
    return dict(port, image=shade.tone_map(color, lut, dtype), stat=count)
