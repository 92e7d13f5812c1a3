"""The comparison of accumulating modes (ReSTIR, the path tracer): the
program's frames against the plain reference's, frame by frame.

For each compared frame the reference renders the same frame index on
the same inputs from scratch. Frame k of a static camera adds the (k+1)th
sample to a running mean, so the reference's accumulation is acc_k =
acc_{k-1} + (sample - acc_{k-1}) / (k + 1), and the program's sample of
frame k is read back from its own accumulation with that count: sample =
acc_{k-1} + (acc_k - acc_{k-1}) * (k + 1). A count or a weight other than
the reference's shows as a sample off. The read-back multiplies the
float32 rounding of acc_k by k + 1, so each pixel's tolerance has a term
of (k + 1) * 2^-22 * max(|acc_k|, |acc_{k-1}|) besides the sample's own.
The displayed image is held to the reference's display transform of the
program's acc_k. The numbers, each the largest over the compared frames:

- pixels_off: the share of pixels whose read-back sample differs from
  the reference's in some channel by more than pixel_atol * (the frame's
  mean |sample|) + pixel_rtol * |reference| + the rounding term, or
  where either sample is not finite;
- display_off: the share of pixels whose displayed value (in [0, 1])
  differs from the reference's display transform of the program's acc_k
  by more than display_atol in some channel, or where either is not
  finite;
- count_off: |count - reference count| / reference count of the frame's
  own count (rays, shadow-ray pixels);
- count_state_off: the largest |sample count in the program's state -
  (k + 1)| over the pixels, over k + 1 (exact: limit 0).
"""

from __future__ import annotations

import torch

from frame_bench.ref import shade

NUMBERS = ("pixels_off", "display_off", "count_off", "count_state_off")
ROUNDING = 2.0 ** -22  # four half-ulps of float32


def keep(prev_state, image, state, stat, older_state=None) -> dict:
    """What the comparison keeps of one frame (references, no copies):
    the state before it, the state and image after it, its count (the
    state before that, older_state, is not needed)."""
    return {"prev": None if prev_state is None else prev_state[0],
            "acc": state[0], "count": state[1], "image": image, "stat": stat}


def numbers(port: dict, ref_sample: torch.Tensor, ref_count: int,
            lut: torch.Tensor, chk: dict, ref_extra: dict | None = None) -> dict:
    """port: a kept frame on the reference's device (ref_extra: nothing
    the accumulating modes' references give)."""
    prev, acc = port["prev"], port["acc"]
    n = float(port["index"] + 1)
    tol = (chk["pixel_atol"] * ref_sample.abs().mean()
           + chk["pixel_rtol"] * ref_sample.abs())
    if prev is None:
        sample = acc
    else:
        sample = prev + (acc - prev) * n
        tol = tol + n * ROUNDING * torch.maximum(acc.abs(), prev.abs())
    bad = (((sample - ref_sample).abs() > tol).any(-1)
           | ~torch.isfinite(sample).all(-1)
           | ~torch.isfinite(ref_sample).all(-1))
    shown = shade.tone_map(acc, lut)
    dbad = (((port["image"] - shown).abs() > chk["display_atol"]).any(-1)
            | ~torch.isfinite(port["image"]).all(-1)
            | ~torch.isfinite(shown).all(-1))
    return {
        "pixels_off": float(bad.float().mean()),
        "display_off": float(dbad.float().mean()),
        "count_off": abs(float(port["stat"]) - ref_count) / max(ref_count, 1),
        "count_state_off": float((port["count"] - n).abs().max()) / n,
    }


def control(port: dict, sample, count, extra, lut, dtype) -> dict:
    """A kept frame as the control would have made it: the control's
    sample accumulated onto the program's state before the frame with
    the reference's count, shown by the control's display transform in
    `dtype`."""
    prev = port["prev"]
    n = float(port["index"] + 1)
    acc = sample if prev is None else prev + (sample - prev) / n
    return dict(port, acc=acc, count=torch.full_like(port["count"], n),
                image=shade.tone_map(acc, lut, dtype), stat=count)
