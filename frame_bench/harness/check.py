"""`correct` from a cell's numbers: each the largest over the compared
frames, each held to its limit."""

from __future__ import annotations


def worst(per_frame: list[dict]) -> dict:
    return {k: max(f[k] for f in per_frame) for k in per_frame[0]}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}); a number missing a limit,
    or not finite, fails."""
    out, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        good = lim is not None and v == v and v <= lim
        ok &= good
        out[k] = {"value": v, "limit": lim}
    return ok, out
