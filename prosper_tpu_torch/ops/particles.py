"""The particle system as a function of its state.

Counterpart of prosper_tpu/ops/particles.py (`init_state`, `_allocate`,
`spawn_emitters`, `simulate`, `render_particles`), particles/*.comp of
the reference: a fixed-capacity pool of {position + lifetime, normal +
spawn rate, velocity + spawn timer, mask}; emitters (lifetime 0, Emit)
steer by their normal and pcg noise and spawn a child (lifetime 4,
Gravity | Decay) every spawn-rate seconds; the free-list allocator is a
prefix-sum over the dead slots (the first free slots to the first
requests); particles draw as depth-tested, Bayer-dithered one-pixel
splats. The mask is an int32 tensor holding the u32 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mathx import rng as prng

MAX_PARTICLES = 1 << 14

MASK_EMIT = 1
MASK_GRAVITY = 2
MASK_DECAY = 4

BAYER8 = np.array(
    [
        [0, 32, 8, 40, 2, 34, 10, 42],
        [48, 16, 56, 24, 50, 18, 58, 26],
        [12, 44, 4, 36, 14, 46, 6, 38],
        [60, 28, 52, 20, 62, 30, 54, 22],
        [3, 35, 11, 43, 1, 33, 9, 41],
        [51, 19, 59, 27, 49, 17, 57, 25],
        [15, 47, 7, 39, 13, 45, 5, 37],
        [63, 31, 55, 23, 61, 29, 53, 21],
    ],
    np.float32,
) / 64.0


def init_state(capacity: int = MAX_PARTICLES, device="cpu") -> dict:
    """An empty pool (lifetime -9999: dead, particle.h's default)."""
    pl = torch.zeros((capacity, 4), dtype=torch.float32, device=device)
    pl[:, 3] = -9999.0
    return {
        "position_lifetime": pl,
        "normal_spawnrate": torch.zeros_like(pl),
        "velocity_spawntimer": torch.zeros_like(pl),
        "mask": torch.zeros((capacity,), dtype=torch.int32, device=device),
    }


def _allocate(dead: torch.Tensor, want: torch.Tensor):
    """Prefix-sum slot allocation, the free-list pop: dead (N,) free
    slots, want (M,) requests -> (slots (M,), granted (M,) bool), the
    r-th request granted the r-th free slot while there are any."""
    n_free = dead.sum()
    req_rank = torch.cumsum(want.to(torch.int64), 0) - 1
    granted = want & (req_rank < n_free)
    order = torch.argsort((~dead).to(torch.int8), stable=True)  # free first
    slots = order[torch.clamp(req_rank, 0, dead.shape[0] - 1)]
    return slots, granted


def _scatter(arr: torch.Tensor, slots, granted, vals) -> torch.Tensor:
    """arr with rows slots[granted] set to vals[granted]; the rest of the
    requests are dropped (the JAX package scatters them out of bounds)."""
    out = arr.clone()
    out[slots[granted]] = vals[granted]
    return out


def spawn_emitters(state: dict, positions: torch.Tensor,
                   normals: torch.Tensor) -> dict:
    """Emitters at world-space points (init.comp:47-58)."""
    n = positions.shape[0]
    dev = positions.device
    dead = state["position_lifetime"][:, 3] < 0.0
    slots, granted = _allocate(dead, torch.ones((n,), dtype=torch.bool,
                                                device=dev))
    zeros = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    return {
        "position_lifetime": _scatter(state["position_lifetime"], slots,
                                      granted, torch.cat([positions, zeros],
                                                         1)),
        "normal_spawnrate": _scatter(state["normal_spawnrate"], slots,
                                     granted,
                                     torch.cat([normals, zeros + 0.1], 1)),
        "velocity_spawntimer": _scatter(state["velocity_spawntimer"], slots,
                                        granted, torch.zeros((n, 4),
                                                             device=dev)),
        "mask": _scatter(state["mask"], slots, granted,
                         torch.full((n,), MASK_EMIT, dtype=torch.int32,
                                    device=dev)),
    }


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp_min((v * v).sum(1, keepdim=True).sqrt(), 1e-9)


def simulate(state: dict, dt, frame_index) -> dict:
    """One simulate + decay step (simulate.comp, decay.comp). dt is
    rounded to float32 first, as the JAX package's jitted step takes it."""
    pl = state["position_lifetime"]
    ns = state["normal_spawnrate"]
    vs = state["velocity_spawntimer"]
    mask = state["mask"]
    cap = mask.shape[0]
    dev = pl.device
    dt = torch.tensor(dt, dtype=torch.float32, device=dev)

    alive = pl[:, 3] >= 0.0
    pos, lifetime = pl[:, :3], pl[:, 3]
    vel, spawn_timer = vs[:, :3], vs[:, 3]
    idx = torch.arange(cap, device=dev)
    st = prng.make_state(idx, idx % 64, frame_index)

    pos = pos + vel * dt
    gravity = (mask & MASK_GRAVITY) != 0
    vel = vel.clone()
    vel[:, 1] = vel[:, 1] + torch.where(gravity, -9.81 * 0.01 * dt, 0.0)
    decay = (mask & MASK_DECAY) != 0
    lifetime = torch.where(decay & alive, lifetime - dt, lifetime)

    # emitters steer and spawn (simulate.comp:60-90)
    emit = ((mask & MASK_EMIT) != 0) & alive
    st, r3 = prng.rnd3d01(st)
    v2 = vel + (ns[:, :3] + r3 * 2.0 - 1.0) * 0.5 * dt
    speed = (v2 * v2).sum(1, keepdim=True).sqrt()
    v2 = v2 / torch.clamp_min(speed, 1e-9) * torch.clamp_max(speed, 0.05)
    vel = torch.where(emit[:, None], v2, vel)
    new_normal = _unit(v2)
    ns = torch.where(emit[:, None], torch.cat([new_normal, ns[:, 3:]], 1), ns)

    spawn_timer = torch.where(emit, spawn_timer + dt, spawn_timer)
    wants_child = emit & (spawn_timer >= ns[:, 3])
    spawn_timer = torch.where(wants_child, 0.0, spawn_timer)

    # expired particles die first, so their slots are free (decay order)
    lifetime = torch.where(decay & (lifetime < 0.0), -9999.0, lifetime)
    slots, granted = _allocate(lifetime < 0.0, wants_child)
    ones = torch.ones((cap, 1), dtype=torch.float32, device=dev)
    child_pl = torch.cat([pos, ones * 4.0], 1)
    child_ns = torch.cat([new_normal, ones * 0.0], 1)
    child_vs = torch.cat([new_normal * 0.02, ones * 0.0], 1)
    return {
        "position_lifetime": _scatter(
            torch.cat([pos, lifetime[:, None]], 1), slots, granted,
            child_pl),
        "normal_spawnrate": _scatter(ns, slots, granted, child_ns),
        "velocity_spawntimer": _scatter(
            torch.cat([vel, spawn_timer[:, None]], 1), slots, granted,
            child_vs),
        "mask": _scatter(mask, slots, granted, torch.full_like(
            mask, MASK_GRAVITY | MASK_DECAY)),
    }


def render_particles(state: dict, hdr: torch.Tensor, depth: torch.Tensor,
                     cam: dict, color=(1.0, 0.8, 0.4),
                     alpha: float = 0.6) -> torch.Tensor:
    """Depth-tested, dithered one-pixel splats over hdr (H, W, 3); depth
    (H, W) reverse-z. Splats off screen, behind the camera, dead, behind
    the surface or dithered away write nothing."""
    h, w = hdr.shape[:2]
    pl = state["position_lifetime"]
    alive = pl[:, 3] >= 0.0
    ph = torch.cat([pl[:, :3], torch.ones_like(pl[:, :1])], 1)
    clip = ph @ cam["world_to_clip"].T
    behind = clip[:, 3] <= 1e-6
    ndc = clip[:, :3] / torch.where(behind, 1.0, clip[:, 3])[:, None]
    x = ((ndc[:, 0] * 0.5 + 0.5) * w).to(torch.int32)
    y = ((ndc[:, 1] * 0.5 + 0.5) * h).to(torch.int32)
    on_screen = (x >= 0) & (x < w) & (y >= 0) & (y < h) & ~behind & alive
    xs = torch.clamp(x, 0, w - 1).long()
    ys = torch.clamp(y, 0, h - 1).long()
    visible = on_screen & (ndc[:, 2] >= depth[ys, xs])
    bayer = torch.as_tensor(BAYER8, device=hdr.device)
    visible = visible & (alpha > bayer[ys % 8, xs % 8])
    out = hdr.clone()
    out[ys[visible], xs[visible]] = torch.tensor(
        color, dtype=torch.float32, device=hdr.device)
    return out
