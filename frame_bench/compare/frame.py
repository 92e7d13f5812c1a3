"""The comparison of frames that stand alone (deferred): each compared
frame's displayed image against the reference's display transform of
the same frame's linear colour, and the frame's own count. The numbers,
each the largest over the compared frames:

- pixels_off: the share of pixels whose displayed value (in [0, 1])
  differs from the reference's by more than display_atol in some
  channel, or where either is not finite;
- count_off: |count - reference count| / reference count of the frame's
  own count (meshlets drawn);
- hiz_off, in a frame whose camera moved, with culling: the larger, of
  the pyramid the frame started from and the one it left for the next,
  of the share of the texels of the program's pyramid's first mip whose
  depth differs from the reference's by more than hiz_rtol of it, or
  where either is not finite (ref/deferred.py: the reference renders
  the frame before from the program's pyramid of the frame before that,
  and the compared frame from its own).
"""

from __future__ import annotations

import torch

from frame_bench.ref import shade

NUMBERS = ("pixels_off", "count_off")
MOVING = ("hiz_off",)  # numbers of the frames of a moving, culled camera


def keep(prev_state, image, state, stat, older_state=None) -> dict:
    """What the comparison keeps of one frame: its image, its count, and
    the HiZ pyramids (culling) of the frame before the one before it, of
    the one before it and its own (references, no copies)."""
    return {"image": image, "stat": stat,
            "older_hiz": (older_state or {}).get("hiz"),
            "prev_hiz": (prev_state or {}).get("hiz"),
            "hiz": (state or {}).get("hiz")}


def _hiz_off(got, want, rtol) -> float:
    """The share of first-mip texels of the program's pyramid `got` off
    the reference's `want` (1.0 where it has none of that size)."""
    want = want[0].to(torch.float32)
    if got is None or tuple(got[0].shape) != tuple(want.shape):
        return 1.0
    off = (((got[0] - want).abs() > rtol * want.abs())
           | ~torch.isfinite(got[0]) | ~torch.isfinite(want))
    return float(off.float().mean())


def numbers(port: dict, ref_color: torch.Tensor, ref_count: int,
            lut: torch.Tensor, chk: dict, ref_extra: dict | None = None) -> dict:
    """port: a kept frame on the reference's device; ref_extra: the
    reference's {"hiz": its pyramid, "hiz_before": the frame before's}
    where the camera moved."""
    shown = shade.tone_map(ref_color, lut)
    img = port["image"]
    bad = (((img - shown).abs() > chk["display_atol"]).any(-1)
           | ~torch.isfinite(img).all(-1) | ~torch.isfinite(shown).all(-1))
    out = {
        "pixels_off": float(bad.float().mean()),
        "count_off": abs(float(port["stat"]) - ref_count) / max(ref_count, 1),
    }
    if ref_extra and "hiz" in ref_extra:
        out["hiz_off"] = max(
            _hiz_off(port.get(k), ref_extra[r], chk["hiz_rtol"])
            for k, r in (("hiz", "hiz"), ("prev_hiz", "hiz_before"))
            if r in ref_extra)
    return out


def control(port: dict, color, count, extra, lut, dtype) -> dict:
    """A kept frame as the control would have made it: the control's
    colour shown by the display transform in `dtype`, its count, and
    the pyramids it made."""
    return dict(port, image=shade.tone_map(color, lut, dtype), stat=count,
                hiz=extra.get("hiz", port.get("hiz")),
                prev_hiz=extra.get("hiz_before", port.get("prev_hiz")))
