"""ReSTIR DI: initial reservoirs -> biased spatial reuse -> traced shading.

Counterpart of prosper_tpu/render/restir.py (`_p_hat` :54,
`initial_reservoirs` :67, `_uniform_sample_disk` :103,
`pack_neighbor_rows` :110, `spatial_reuse` :127, `restir_shade` :230,
`render_restir` :330, `restir_entry` :468), restir_di/ and
rt/direct_illumination/main.rgen of the reference:

- initial reservoirs: 5 uniform light candidates (the sun is light 0),
  streaming RIS with MIS weight 1/M; reservoir = {light index, UCW};
- biased spatial reuse: 5 samples in a 30 px disk, up to 5 rejection
  tries each (10% linear depth, normal dot 0.9), MIS weight 1/(number
  of neighbours that passed, empty reservoirs included);
- shading: one shadow ray (t_min 0.1) to the winning light, times its
  UCW, and the running mean of the path tracer's accumulation.

pHat = luminance(irradiance * BRDF * NoL), without visibility. Every
pass reseeds its RNG with (px, py, frame index), and the data-dependent
advances (the rejection loop, the valid-sample-only resampling) are
per-pixel masked advances, so each pixel's stream is fixed by its
absolute coordinates.

The port runs every pass densely over the row-major frame. The JAX
package's tile compaction (`ops/compact.tile_apply`), block16 pixel
order and `blocks_to_rows` and the Morton light-position sort of the
shadow rays change only the order and extent of work, not results
(restir.py:346-351, :396-403), and are not carried. spatial_reuse
reads the whole frame's neighbour rows, or a band's rows and its halo
(neigh_y0, neigh_rows_h; render/distributed.py). On CUDA tensors it runs
as one hand-written kernel, csrc/restir_spatial.cu, one thread per
pixel; spatial_reuse_plain is its plain twin, which CPU tensors take.
The ris_initial pass (initial_reservoirs, the valid mask,
pack_neighbor_rows) runs likewise through initial_neighbor_rows: on CUDA
tensors csrc/restir_initial.cu writes the neighbour rows in one pass,
on CPU tensors initial_neighbor_rows_plain composes the three steps.

The shadow rays go, in 16x16-block order (ops/trace.traced_in_blocks),
through the any-hit fn of ops/trace.make_bounce_tracer when
config.policy.bounce_tracer is "leafmajor" on a frame with BVH arrays
(restir.py:250-261, :383-393: K14 for light rays, K3 for heavy ones),
else through ops/trace.make_tracer's: K3 or, under
config.policy.any_tracer = "dense", K10 on frames with BVH arrays, K7
without.

The passes run under gprofiler.span scopes (torch.profiler.
record_function ranges, and host spans while recording) named as the
JAX package's jax.named_scope passes (restir.py:359-461, pt.py:918-921):
gbuffer, ris_initial, spatial_shade, accumulate and tonemap, which
utils/profiler.profile_passes reads; restir_entry is the frame span.
"""

from __future__ import annotations

import ctypes
import math
import operator
from functools import lru_cache

import torch

from ..mathx import rng as prng
from ..mathx.color import luminance
from ..mathx.packing import signed_oct_decode
from ..ops.brdf import eval_brdf_times_nol
from ..ops.tonemap import device_lut, tone_map
from ..ops.trace import (
    frame_bvh,
    make_bounce_tracer,
    make_tracer,
    traced_in_blocks,
)
from ..ops.trace_bvh import check_stack_overflow, expect_tensor
from ..scene.convert import camera_tensors, check_device
from ..scene.lights import MAX_POINT_LIGHTS, MAX_SPOT_LIGHTS
from ..utils.profiler import gprofiler
from .gbuffer import render_gbuffer
from .pt import pt_accumulate
from .shading import sample_light

INITIAL_CANDIDATES = 5
SPATIAL_SAMPLES = 5
SPATIAL_RADIUS = 30.0
MAX_TRIES = 5
SHADOW_T_MIN = 0.1  # main.rgen shadow() tMin (restir.py:261, :311)


def _dot(a, b):
    return (a * b).sum(-1)


def _p_hat(surface: dict, lights: dict, light_index):
    l, _, irr = sample_light(lights, light_index, surface["position_ws"])
    brdf = eval_brdf_times_nol(
        l, surface["inv_view_ray"], surface["normal_ws"], surface["albedo"],
        surface["roughness"], surface["metallic"],
    )
    return luminance(irr * brdf)


def initial_reservoirs(surface: dict, lights: dict, px, py, frame_index):
    """(R,) light index (-1 invalid) + (R,) UCW (initial_reservoirs.comp)."""
    state = prng.make_state(px, py, frame_index)
    # the sun is light 0, then the point and spot lights
    light_count = (1 + lights["point_count"] + lights["spot_count"]).to(
        torch.float32)
    R = px.shape[0]
    dev = px.device
    res_light = torch.full((R,), -1, dtype=torch.int64, device=dev)
    sum_w = torch.zeros((R,), dtype=torch.float32, device=dev)
    res_phat = torch.zeros_like(sum_w)
    mis = 1.0 / INITIAL_CANDIDATES
    for _ in range(INITIAL_CANDIDATES):
        state, u = prng.rnd01(state)
        li = torch.minimum((u * light_count).to(torch.int64),
                           (light_count - 1.0).to(torch.int64))
        phat = _p_hat(surface, lights, li)
        w = mis * phat * light_count
        sum_w = sum_w + w
        state, accept_u = prng.rnd01(state)
        accept = accept_u < w / torch.where(sum_w > 0, sum_w, 1.0)
        res_light = torch.where(accept, li, res_light)
        # the accepted candidate's pHat rides along (no recompute)
        res_phat = torch.where(accept, phat, res_phat)
    ucw = torch.where(res_light >= 0,
                      sum_w / torch.clamp_min(res_phat, 1e-20), 0.0)
    return res_light, ucw


def _uniform_sample_disk(u):
    """sampling.glsl:8-13."""
    r = torch.sqrt(u[..., 0])
    theta = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def pack_neighbor_rows(gbuf: dict, res_light, res_ucw):
    """One (R, 8) row per pixel for the spatial rejection loop: linear
    depth | oct normal | light index | UCW | 0 0, one gather per try."""
    R = res_light.shape[0]
    return torch.cat([
        gbuf["linear_depth"][:, None],
        gbuf["normal_metallic"][:, :3],
        res_light.to(torch.float32)[:, None],
        res_ucw[:, None],
        torch.zeros((R, 2), dtype=torch.float32, device=res_ucw.device),
    ], dim=-1)


def spatial_reuse_plain(surface: dict, lights: dict, neigh_rows, px, py,
                        width: int, height: int, frame_index,
                        neigh_y0: int = 0, neigh_rows_h: int | None = None):
    """Biased spatial reuse (spatial_reuse.comp) -> (R,) light index,
    (R,) UCW, in plain PyTorch: the twin of csrc/restir_spatial.cu,
    which spatial_reuse runs on CPU tensors. neigh_rows: the
    pack_neighbor_rows image, row-major, of rows [neigh_y0, neigh_y0 +
    neigh_rows_h) of the frame (the whole frame by default; a band and
    its halo under render/distributed.py).
    px, py, width and height are absolute frame coordinates: the RNG
    streams and the edge test read them. Reproduces the reference's
    quirks: a neighbour in pixel row or column 0 is rejected
    (`lessThanEqual(p, 0)`), the valid count includes neighbours whose
    reservoir is empty, and the RNG advances only on valid samples."""
    state = prng.make_state(px, py, frame_index)
    R = px.shape[0]
    dev = px.device
    lin_depth = surface["linear_depth"]
    normal = surface["normal_ws"]
    safe_depth = torch.where(lin_depth != 0, lin_depth, 1.0)
    rows_h = height if neigh_rows_h is None else neigh_rows_h

    samples = []
    for _ in range(SPATIAL_SAMPLES):
        found = torch.zeros((R,), dtype=torch.bool, device=dev)
        s_li = torch.full((R,), -1, dtype=torch.int64, device=dev)
        s_ucw = torch.zeros((R,), dtype=torch.float32, device=dev)
        for _ in range(MAX_TRIES):
            trying = ~found
            state_n, u2 = prng.rnd2d01(state)
            state = torch.where(trying[:, None], state_n, state)
            r = (_uniform_sample_disk(u2) * SPATIAL_RADIUS * 2.0
                 - SPATIAL_RADIUS).to(torch.int32)
            p_x = px + r[:, 0]
            p_y = py + r[:, 1]
            in_bounds = (p_x > 0) & (p_y > 0) & (p_x < width) & (p_y < height)
            p_flat = (torch.clamp(p_y - neigh_y0, 0, rows_h - 1) * width
                      + torch.clamp(p_x, 0, width - 1))
            row = neigh_rows[p_flat]  # one gather per try
            depth_ok = torch.abs(1.0 - row[:, 0] / safe_depth) <= 0.1
            nrm_ok = _dot(signed_oct_decode(row[:, 1:4]), normal) >= 0.9
            ok = trying & in_bounds & depth_ok & nrm_ok
            s_li = torch.where(ok, row[:, 4].to(torch.int64), s_li)
            s_ucw = torch.where(ok, row[:, 5], s_ucw)
            found = found | ok
        samples.append((torch.where(found, s_li, -1),
                        torch.where(found, s_ucw, 0.0), found))

    valid_count = torch.zeros((R,), dtype=torch.float32, device=dev)
    for _, _, f in samples:
        valid_count = valid_count + f.to(torch.float32)

    out_light = torch.full((R,), -1, dtype=torch.int64, device=dev)
    out_phat = torch.zeros((R,), dtype=torch.float32, device=dev)
    sum_w = torch.zeros_like(out_phat)
    for li, ucw, _ in samples:
        valid = li >= 0
        phat = _p_hat(surface, lights, torch.clamp_min(li, 0))
        w = torch.where(valid, phat * ucw, 0.0)
        sum_w = sum_w + w
        # the GLSL consumes rnd01 only for valid samples
        state_n, u = prng.rnd01(state)
        state = torch.where(valid[:, None], state_n, state)
        accept = valid & (u < w / torch.where(sum_w > 0, sum_w, 1.0))
        out_light = torch.where(accept, li, out_light)
        out_phat = torch.where(accept, phat, out_phat)
    out_ucw = torch.where(
        out_light >= 0,
        (1.0 / torch.clamp_min(valid_count, 1.0)) * sum_w
        / torch.clamp_min(out_phat, 1e-20),
        0.0,
    )
    return out_light, out_ucw


# the C entry points' arguments before the stream (cuda_build.launch)
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 4 + [ctypes.c_uint32] + [ctypes.c_void_p] * 2)
_INITIAL_ARGTYPES = ([ctypes.c_void_p] * 11 + [ctypes.c_int]
                     + [ctypes.c_void_p] * 3 + [ctypes.c_uint32]
                     + [ctypes.c_void_p])
# the surface planes the kernels read: key, trailing shape
_SURFACE_PLANES = (("linear_depth", ()), ("normal_ws", (3,)),
                   ("position_ws", (3,)), ("inv_view_ray", (3,)),
                   ("albedo", (3,)), ("roughness", ()), ("metallic", ()))


def _kernel_inputs(name: str, surface: dict, lights: dict, px, py):
    """The checks both kernels make -> (the surface planes, contiguous,
    in _SURFACE_PLANES order; the packed light rows). Raises off CUDA."""
    dev = px.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    R = px.shape[0]
    # the G-buffer's albedo is a view of a wider plane: made contiguous
    planes = [surface[key].contiguous() for key, _ in _SURFACE_PLANES]
    for (key, tail), t in zip(_SURFACE_PLANES, planes):
        expect_tensor(t, key, torch.float32, dev, (R, *tail))
    expect_tensor(px, "px", torch.int64, dev, (R,))
    expect_tensor(py, "py", torch.int64, dev, (R,))
    rows = lights["packed_rows"]
    expect_tensor(rows, "packed_rows", torch.float32, dev, (None, 12))
    _expect_aligned("packed_rows", rows)
    return planes, rows


def _expect_aligned(name: str, t) -> None:
    """Raise unless t's data is 16-byte aligned (float4 loads)."""
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _frame_word(frame_index) -> int:
    """The frame index's low 32 bits: the RNG's u32 word. A Python int:
    a tensor would make the host wait for its value."""
    if isinstance(frame_index, torch.Tensor):
        raise TypeError("frame_index: expected a Python int, got a tensor")
    return operator.index(frame_index) & 0xFFFFFFFF


def _spatial_kernel(surface: dict, lights: dict, neigh_rows, px, py,
                    width: int, height: int, frame_index: int, neigh_y0: int,
                    rows_h: int):
    """Check the inputs and launch csrc/restir_spatial.cu -> (R,) int64
    light index, (R,) f32 UCW."""
    from ..ops import cuda_build

    planes, rows = _kernel_inputs("spatial_reuse", surface, lights, px, py)
    dev, R = px.device, px.shape[0]
    expect_tensor(neigh_rows, "neigh_rows", torch.float32, dev,
                  (rows_h * width, 8))
    _expect_aligned("neigh_rows", neigh_rows)
    frame = _frame_word(frame_index)
    out_light = torch.empty((R,), dtype=torch.int64, device=dev)
    out_ucw = torch.empty((R,), dtype=torch.float32, device=dev)
    cuda_build.launch("restir_spatial", "spatial_reuse", _ARGTYPES, dev, (
        *(t.data_ptr() for t in planes), px.data_ptr(), py.data_ptr(), R,
        neigh_rows.data_ptr(), rows.data_ptr(), width, height, neigh_y0,
        rows_h, frame, out_light.data_ptr(), out_ucw.data_ptr()))
    return out_light, out_ucw


def spatial_reuse(surface: dict, lights: dict, neigh_rows, px, py,
                  width: int, height: int, frame_index, neigh_y0: int = 0,
                  neigh_rows_h: int | None = None):
    """Biased spatial reuse -> (R,) int64 light index (-1: none), (R,)
    f32 UCW; arguments as spatial_reuse_plain's. On CPU tensors it runs
    spatial_reuse_plain; on CUDA tensors the kernel of
    csrc/restir_spatial.cu (frame_index a Python int) or raises, and
    counts its launches in `.launches`."""
    if px.device.type == "cpu":
        return spatial_reuse_plain(surface, lights, neigh_rows, px, py,
                                   width, height, frame_index, neigh_y0,
                                   neigh_rows_h)
    out = _spatial_kernel(surface, lights, neigh_rows, px, py, width, height,
                          frame_index, neigh_y0,
                          height if neigh_rows_h is None else neigh_rows_h)
    # on the wrapper itself, which a recorder patched over the module's
    # name calls
    KERNELS[0].launches += 1
    return out


def initial_neighbor_rows_plain(surface: dict, lights: dict, normal_metallic,
                                valid, px, py, frame_index):
    """The ris_initial pass in plain PyTorch -> the (R, 8)
    pack_neighbor_rows image the spatial reuse reads: initial_reservoirs,
    the light index masked by `valid` (the UCW left as it is), then
    pack_neighbor_rows over surface["linear_depth"] and normal_metallic
    (R, 4). The twin of csrc/restir_initial.cu, which
    initial_neighbor_rows runs on CPU tensors."""
    li0, ucw0 = initial_reservoirs(surface, lights, px, py, frame_index)
    li0 = torch.where(valid, li0, -1)
    return pack_neighbor_rows(
        {"linear_depth": surface["linear_depth"],
         "normal_metallic": normal_metallic}, li0, ucw0)


def _initial_kernel(surface: dict, lights: dict, normal_metallic, valid, px,
                    py, frame_index: int):
    """Check the inputs and launch csrc/restir_initial.cu -> (R, 8) f32
    neighbour rows."""
    from ..ops import cuda_build

    planes, rows = _kernel_inputs("initial_neighbor_rows", surface, lights,
                                  px, py)
    dev, R = px.device, px.shape[0]
    expect_tensor(normal_metallic, "normal_metallic", torch.float32, dev,
                  (R, 4))
    _expect_aligned("normal_metallic", normal_metallic)
    expect_tensor(valid, "valid", torch.bool, dev, (R,))
    # the kernel picks among the counted lights, which it counts on the
    # device: every row scene.lights.light_uniforms lays out must be there
    n_rows = 1 + MAX_POINT_LIGHTS + MAX_SPOT_LIGHTS
    if rows.shape[0] < n_rows:
        raise ValueError(f"packed_rows: expected {n_rows} rows, got "
                         f"{rows.shape[0]}")
    counts = (lights["point_count"], lights["spot_count"])
    for name, t in zip(("point_count", "spot_count"), counts):
        # a scalar: 0-d, or (1,) as a pinned upload leaves it
        expect_tensor(t, name, torch.int32, dev)
        if t.numel() != 1:
            raise ValueError(f"{name}: expected one element, got "
                             f"{tuple(t.shape)}")
    frame = _frame_word(frame_index)
    out = torch.empty((R, 8), dtype=torch.float32, device=dev)
    cuda_build.launch("restir_initial", "ris_initial", _INITIAL_ARGTYPES,
                      dev, (
        planes[0].data_ptr(), normal_metallic.data_ptr(),
        *(t.data_ptr() for t in planes[1:]), valid.data_ptr(),
        px.data_ptr(), py.data_ptr(), R, rows.data_ptr(),
        *(t.data_ptr() for t in counts), frame, out.data_ptr()))
    return out


def initial_neighbor_rows(surface: dict, lights: dict, normal_metallic,
                          valid, px, py, frame_index):
    """The ris_initial pass -> (R, 8) f32 neighbour rows; arguments as
    initial_neighbor_rows_plain's. On CPU tensors it runs
    initial_neighbor_rows_plain; on CUDA tensors the kernel of
    csrc/restir_initial.cu (frame_index a Python int; the light counts
    read on the device) or raises, and counts its launches in
    `.launches`."""
    if px.device.type == "cpu":
        return initial_neighbor_rows_plain(surface, lights, normal_metallic,
                                           valid, px, py, frame_index)
    out = _initial_kernel(surface, lights, normal_metallic, valid, px, py,
                          frame_index)
    KERNELS[1].launches += 1
    return out


spatial_reuse.launches = 0
initial_neighbor_rows.launches = 0
KERNELS = (spatial_reuse, initial_neighbor_rows)


def shadow_tracer(scene: dict, width: int, height: int):
    """any_fn(o, d, t_min, t_max) -> (R,) bool for the row-major shadow
    rays of a whole frame: the leaf-major hybrid's any-hit fn when
    ops/trace.make_bounce_tracer gives one, else ops/trace.make_tracer's
    (K3, K10 or K7, as the frame and config.policy decide), traced in
    16x16 pixel blocks, whose packets are narrower than 256x1 row strips;
    the order does not change the mask."""
    frame = scene["frame"]
    args = (scene["geom"]["packed9"], frame["wc_aabb_min_w"],
            frame["wc_aabb_max_w"])
    bounce_tr = make_bounce_tracer(*args, frame_bvh(frame))
    if bounce_tr is None:
        _, any_fn = make_tracer(*args, bvh=frame_bvh(frame))
    else:
        any_fn = bounce_tr["any"]
    return traced_in_blocks(any_fn, width, height)


def restir_shade(surface: dict, lights: dict, res_light, res_ucw, any_fn):
    """Traced final shading (main.rgen evaluateDirectLightingReSTIR) ->
    ((R, 3) color, (R,) bool: the pixels that traced a shadow ray)."""
    li = torch.clamp_min(res_light, 0)
    l, dist, irr = sample_light(lights, li, surface["position_ws"])
    front = _dot(l, surface["normal_ws"]) > 0.0
    valid = ((res_light >= 0) & front & surface["valid"]
             & (surface["alpha"] != 0.0))
    up = torch.zeros_like(l)
    up[:, 2] = 1.0
    shadow_o = torch.where(valid[:, None], surface["position_ws"], 0.0)
    shadow_d = torch.where(valid[:, None], l, up)
    shadow_tmax = torch.where(valid, dist, 0.0)
    occluded = any_fn(shadow_o.contiguous(), shadow_d.contiguous(),
                      SHADOW_T_MIN, shadow_tmax)
    vis = torch.where(valid & ~occluded, 1.0, 0.0)
    color = (
        irr
        * vis[:, None]
        * eval_brdf_times_nol(
            l, surface["inv_view_ray"], surface["normal_ws"],
            surface["albedo"], surface["roughness"], surface["metallic"],
        )
        * res_ucw[:, None]
    )
    return torch.where(valid[:, None], color, 0.0), valid


@lru_cache(maxsize=4)
def _pixel_coords(width: int, height: int, device: str):
    """(px, py) int64 of the row-major pixels."""
    px = torch.arange(width, device=device).repeat(height)
    py = torch.arange(height, device=device).repeat_interleave(width)
    return px, py


def render_restir(scene: dict, cam: dict, width: int, height: int,
                  frame_index: int, alpha_rounds: int = 0):
    """Full ReSTIR DI frame: G-buffer -> reservoirs -> spatial -> trace.
    Returns ((R, 3) linear color, row-major; the number of shadow rays).
    The tone map is restir_entry's, after the accumulation (the JAX
    function's tone=False form). Raises if a trace kernel overflowed its
    node stack."""
    frame = scene["frame"]
    dev = scene["geom"]["packed_full"].device
    with gprofiler.span("gbuffer"):
        gbuf = render_gbuffer(scene, cam, width, height,
                              alpha_rounds=alpha_rounds)
        surface = dict(gbuf["surface"])
        # linear depth from the non-linear buffer, as the comp shaders do
        c2c = cam["camera_to_clip"]
        surface["linear_depth"] = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
    px, py = _pixel_coords(width, height, str(dev))
    lights = frame["lights"]

    with gprofiler.span("ris_initial"):
        neigh_rows = initial_neighbor_rows(surface, lights,
                                           gbuf["normal_metallic"],
                                           gbuf["valid"], px, py, frame_index)
    with gprofiler.span("spatial_shade"):
        li1, ucw1 = spatial_reuse(surface, lights, neigh_rows, px, py, width,
                                  height, frame_index)
        color, traced = restir_shade(surface, lights, li1, ucw1,
                                     shadow_tracer(scene, width, height))
    check_stack_overflow(dev, "restir.stack_check")
    return color, traced.sum()


def restir_entry(*, scene, cam, lut, width, height, device="cuda",
                 exposure=1.0, contrast=1.0, frame_index=0, state=None,
                 alpha_rounds=0, return_stats=False):
    """ReSTIR mode: one frame, accumulated into state (None starts anew:
    the frame itself with a count of 1) with the path tracer's running
    mean, tone mapped. Returns (image (H, W, 3), (accumulated color,
    sample count)), and the number of shadow rays third when
    return_stats."""
    with gprofiler.frame("restir", frame_index):
        dev = check_device(scene, device)
        color, n_shadow = render_restir(scene, camera_tensors(cam, dev),
                                        width, height, frame_index,
                                        alpha_rounds)
        sample = color.reshape(height, width, 3)
        with gprofiler.span("accumulate"):
            if state is None:
                acc = sample
                count = torch.ones((height, width), dtype=torch.float32,
                                   device=dev)
            else:
                acc, count = pt_accumulate(state[0], state[1], sample)
        with gprofiler.span("tonemap"):
            img = tone_map(acc, device_lut(lut, dev), exposure, contrast)
    if return_stats:
        return img, (acc, count), n_shadow
    return img, (acc, count)
