"""Wavefront path tracer.

Counterpart of prosper_tpu/render/pt.py: `pt_trace_pixels` (:86),
`pt_render_sample` (:846), `pt_accumulate` (:900) and `pt_entry` (:926),
main.rgen of the reference. One structure on every device: the primary
pass runs the primary trace kernel (in-kernel raygen, (R, 16) rows ->
`unpack_hit16`), and each bounce picks a light, traces its shadow ray
through ops/trace.make_tracer's any-hit fn (t_min 0.1: K3, or K10 under
config.policy.any_tracer = "dense"), samples the BRDF with Russian
roulette, and traces the bounce ray through the closest-hit kernel K2
((R, 8) rows -> `attrs_from_hit_rows`). On a frame without BVH arrays
(pt.py:184-193) the primary rays are the pinhole rays, primary and
bounce rays take the flat kernel K8 ((R, 16) rows) and shadow rays K7;
the wavefront is already in 16x16-block order, the order the flat
kernels cull in. Under config.policy.bounce_tracer = "leafmajor" a frame
with BVH arrays sends its shadow and bounce rays through the exact
hybrid of ops/trace.make_bounce_tracer (pt.py:208-215, :439-440,
:711-714): K14's pair blocks for light rays, K3 and K2 for heavy ones,
bounce rays with t_min 1e-4, as the JAX package passes on that path;
primary rays stay on K1. On CUDA tensors the kernels run; on CPU
tensors their plain versions do.

The options follow the JAX package's kernel path (pt.py:173-191):
use_dof makes thin-lens primary rays here and traces them with K4 (K8
without BVH arrays) at t_min 0; alpha_rounds > 0 runs the stochastic
alpha retrace (pt.py:235-272) through K4 (K8) after the primary trace
and after every bounce trace (K2 + attrs_from_hit_rows, K8, or the
leaf-major closest_full); env, packed once a frame, lights the primary
misses and, times the throughput, every bounce miss (pt.py:625-631,
:743-751).

RNG order matches pt.py:14-16 call for call: uv jitter (1 advance),
the lens draw under use_dof (1), then per bounce light pick (1,
masked), bounce pick (1), bounce direction (1), roulette (1, from
bounce 2 on).

The wavefront runs densely over every pixel, with dead rays disabled by
t_max = 0, as the JAX code does inside each tile. The JAX package's
tile compaction (ops/compact.tile_apply), coherence sort keys, primary
tile mask and TPU row layouts change only the order and extent of work,
not results, and are not carried over.

The passes run under gprofiler.span scopes (torch.profiler.
record_function ranges, and host spans while recording) named as the
JAX package's jax.named_scope passes, primary_trace (pt.py:575),
wavefront (:826), accumulate and tonemap (:918-921), which
utils/profiler.profile_passes reads; pt_entry is the frame span.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .. import config
from ..mathx import rng as prng
from ..ops.brdf import (
    cook_torrance_brdf,
    cosine_hemisphere_pdf,
    cosine_sample_hemisphere,
    eval_brdf_times_nol,
    fresnel_zero,
    lambert_brdf,
    orthonormal_basis,
    sample_visible_trowbridge_reitz,
    saturate,
    visible_trowbridge_reitz_pdf,
)
from ..ops.ibl import pack_cubemap_rows, sample_cubemap
from ..ops.rays import offset_ray, pinhole_rays, thin_lens_rays
from ..ops.slabs import attrs_from_hit_rows, unpack_hit8, unpack_hit16
from ..ops.texture import sample_alpha_packed
from ..ops.tonemap import device_lut, tone_map
from ..ops.trace import (
    frame_bvh,
    make_bounce_tracer,
    make_tracer,
    permute16,
    pixel_layouts_np,
)
from ..ops.trace_bvh import (
    check_stack_overflow,
    primary_cam_vec,
    trace_closest_bvh,
    trace_closest_bvh_full,
    trace_primary_bvh_full,
)
from ..ops.trace_flat import trace_closest_flat_full
from ..scene.convert import camera_tensors, check_device
from ..utils.profiler import gprofiler
from .shading import sample_light
from .surface import evaluate_surface_from_attrs

ROULETTE_START_BOUNCE = 1  # reference UI default (RtReference.hpp)
SHADOW_T_MIN = 0.1  # main.rgen shadow() tMin
BOUNCE_T_MIN = 0.0  # the t_min pt.py passes for primary and bounce traces
LEAFMAJOR_BOUNCE_T_MIN = 1e-4  # bounce t_min on the leaf-major path (:712)
ALPHA_T_MIN = 0.0  # the alpha retrace's t_min (pt.py:259)


def _dot(a, b):
    return (a * b).sum(-1)


@lru_cache(maxsize=4)
def _pixel_layouts(width: int, height: int, device: str):
    """Device copies of trace.pixel_layouts_np, cached per resolution."""
    px, py, cols, inv16 = pixel_layouts_np(width, height)
    return (
        torch.as_tensor(px.astype(np.int64), device=device),
        torch.as_tensor(py.astype(np.int64), device=device),
        torch.as_tensor(cols, device=device),
        torch.as_tensor(inv16, device=device),
    )


def primary_streams(cam: dict, px, py, width: int, height: int, frame_index,
                    use_dof: bool = False):
    """Per-pixel RNG state after the uv jitter (and, under use_dof, the
    lens draw), and the primary ray (main.rgen:227-240): pinhole, or
    thin-lens under use_dof."""
    st = prng.make_state(px, py, frame_index)
    st, jitter = prng.rnd2d01(st)
    with gprofiler.wait("pt.resolution"):
        res = torch.tensor([float(width), float(height)],
                           dtype=torch.float32, device=px.device)
    uvj = (torch.stack([px, py], dim=-1).to(torch.float32) + jitter) / res
    if use_dof:
        st, lens = prng.rnd2d01(st)
        o, d = thin_lens_rays(cam, uvj, lens)
    else:
        o, d = pinhole_rays(cam, uvj)
    return st, o, d


def alpha_retrace(arena: dict, closest_full, alpha_rounds: int, state, o, d,
                  tmax, hit: dict) -> dict:
    """The stochastic any-hit retrace (scene.rahit; pt.py:235-272): a hit
    that the mask test rejects, or whose blend alpha lies below the ray's
    uniform pcg(state.x ^ state.z) (drawn without advancing the stream),
    is traced again from just past it through closest_full(o, d, t_min,
    t_max) -> full hit dict, up to alpha_rounds times; the distance
    skipped is added back to t."""
    au = prng.rng_to01(prng.pcg(state[..., 0] ^ state[..., 2]))
    t_off = torch.zeros_like(hit["t"])
    o_cur, tmax_cur = o, tmax
    for _ in range(alpha_rounds):
        a = sample_alpha_packed(arena, hit["material"], hit["uv"])
        ignore = (hit["tri"] >= 0) & ((a == 0.0) | ((a > 0.0) & (au > a)))
        adv = torch.where(ignore, hit["t"] * (1.0 + 1e-4) + 1e-5, 0.0)
        o_cur = o_cur + d * adv[..., None]
        tmax_cur = torch.where(ignore, torch.clamp_min(tmax_cur - adv, 0.0),
                               0.0)
        t_off = t_off + adv
        hit2 = closest_full(o_cur.contiguous(), d.contiguous(), ALPHA_T_MIN,
                            tmax_cur)
        hit = {k: torch.where(ignore.reshape(ignore.shape + (1,) * (
            v.dim() - 1)), hit2[k], v) for k, v in hit.items()}
    hit = dict(hit)
    hit["t"] = hit["t"] + t_off
    return hit


def _shade_and_bounce(scene, bounce, state, color, throughput, active,
                      ray_o, ray_d, hit, clamp_indirect, any_fn):
    """Shade one wavefront's hits and generate its bounce rays
    (main.rgen:92-276; pt.py shade_and_bounce :371-545); any_fn traces
    the shadow rays."""
    lights = scene["frame"]["lights"]
    light_count = (
        1 + lights["point_count"] + lights["spot_count"]
    ).to(torch.float32)
    hit_valid = (hit["tri"] >= 0) & active
    # secondary surfaces sample at one coarse mip when
    # config.policy.bounce_tap_mip > 0; primary ones at the base mip
    mip = config.policy.bounce_tap_mip if bounce > 0 else 0
    surface = evaluate_surface_from_attrs(scene["arena"], ray_o, ray_d, hit,
                                          fixed_mip=mip if mip > 0 else None)

    # direct light: the light-pick advance is skipped on misses and on
    # alpha == 0 surfaces, as evaluateDirectLighting returns early there
    state_dl, pick = prng.rnd01(state)
    adv_dl = hit_valid & (surface["alpha"] != 0.0)
    state = torch.where(adv_dl[..., None], state_dl, state)
    light_index = torch.minimum(
        (pick * light_count).to(torch.int64),
        (light_count - 1.0).to(torch.int64),
    )
    l, dist, irradiance = sample_light(
        lights, light_index, surface["position_ws"]
    )
    front = _dot(l, surface["normal_ws"]) > 0.0
    need_shadow = hit_valid & front & (surface["alpha"] != 0.0)
    # rays without a shadow test keep a finite origin and direction and
    # are disabled with t_max = 0
    shadow_o = torch.where(need_shadow[..., None], surface["position_ws"], ray_o)
    shadow_d = torch.where(need_shadow[..., None], l, ray_d)
    shadow_tmax = torch.where(need_shadow, dist, 0.0)
    occluded = any_fn(shadow_o.contiguous(), shadow_d.contiguous(),
                      SHADOW_T_MIN, shadow_tmax)
    vis = torch.where(need_shadow & ~occluded, 1.0, 0.0)
    direct = (
        throughput
        * irradiance
        * vis[..., None]
        * light_count
        * eval_brdf_times_nol(
            l, surface["inv_view_ray"], surface["normal_ws"],
            surface["albedo"], surface["roughness"], surface["metallic"],
        )
    )
    contrib = torch.where(hit_valid[..., None], direct, 0.0)
    if clamp_indirect and bounce > 0:
        contrib = torch.clamp(contrib, 0.0, 2.0)
    color = color + contrib

    # bounce importance sampling: diffuse vs VNDF, one-sample MIS
    state, pick_u = prng.rnd01(state)
    state, samp = prng.rnd2d01(state)
    n = surface["normal_ws"]
    view = surface["inv_view_ray"]
    specular_weight = torch.where(surface["metallic"] > 0.999, 1.0, 0.5)
    diffuse_weight = 1.0 - specular_weight
    pick_diffuse = pick_u < diffuse_weight

    basis = orthonormal_basis(n)  # rows b1, b2, n
    v_basis = (basis * view[..., None, :]).sum(-1)
    alpha = surface["roughness"] * surface["roughness"]

    rd_diff = cosine_sample_hemisphere(n, samp)
    NoL_diff = saturate(_dot(n, rd_diff))
    brdf_diff = lambert_brdf(surface["albedo"])
    pdf_diff = cosine_hemisphere_pdf(NoL_diff) * diffuse_weight

    rd_spec_basis = sample_visible_trowbridge_reitz(v_basis, alpha, samp)
    rd_spec = (basis * rd_spec_basis[..., :, None]).sum(-2)
    NoL_spec = saturate(_dot(n, rd_spec))
    h = view + rd_spec
    h = h / torch.clamp_min((h * h).sum(-1, keepdim=True).sqrt(), 1e-20)
    NoH = saturate(_dot(n, h))
    VoH = saturate(_dot(view, h))
    f0 = fresnel_zero(surface["albedo"], surface["metallic"])
    brdf_spec = cook_torrance_brdf(
        NoL_spec, surface["NoV"], NoH, VoH, f0, surface["roughness"]
    )
    pdf_spec = (
        visible_trowbridge_reitz_pdf(v_basis, rd_spec_basis, alpha)
        * specular_weight
    )

    rd = torch.where(pick_diffuse[..., None], rd_diff, rd_spec)
    brdf = torch.where(pick_diffuse[..., None], brdf_diff, brdf_spec)
    NoL = torch.where(pick_diffuse, NoL_diff, NoL_spec)
    pdf = torch.where(pick_diffuse, pdf_diff, pdf_spec)
    w_raw = brdf * (NoL / pdf)[..., None]
    # GLSL max(x, 0) turns NaN/inf-pdf samples into 0
    w = torch.where((w_raw >= 0.0) & torch.isfinite(w_raw), w_raw, 0.0)
    throughput = torch.where(hit_valid[..., None], throughput * w, throughput)

    # Russian roulette (main.rgen:270-276): the advance happens only
    # after rouletteStartBounce, uniformly per bounce
    if bounce > ROULETTE_START_BOUNCE:
        state, rr = prng.rnd01(state)
        kill = rr < torch.clamp_min(1.0 - throughput.amax(dim=-1), 0.05)
        active = active & ~kill
    active = active & hit_valid
    ray_o = torch.where(
        active[..., None], offset_ray(surface["position_ws"], n), ray_o
    )
    ray_d = torch.where(active[..., None], rd, ray_d)
    return state, color, throughput, active, ray_o, ray_d, need_shadow


def _closest_full_fn(geom: dict, frame: dict):
    """fn(o, d, t_min, t_max) -> full hit dict: K4 on a frame with BVH
    arrays, K8 without (the JAX package's kernel-path trace_closest_fn,
    pt.py:181-193)."""
    bvh = frame_bvh(frame)
    if bvh is not None:
        def fn(o, d, t_min, t_max):
            return unpack_hit16(trace_closest_bvh_full(
                geom["packed_full"], *bvh, o, d, t_min, t_max))
    else:
        def fn(o, d, t_min, t_max):
            return unpack_hit16(trace_closest_flat_full(
                geom["packed_full"], frame["wc_aabb_min_w"],
                frame["wc_aabb_max_w"], o, d, t_min, t_max))
    return fn


def pt_trace_pixels(scene: dict, cam: dict, px, py, pix_cols, width: int,
                    height: int, frame_index: int, max_bounces: int = 3,
                    clamp_indirect: bool = False, use_dof: bool = False,
                    env=None, alpha_rounds: int = 0):
    """Path-trace the pixels (px, py) -> ((R, 3) color, ray count).

    pix_cols: the (T, 3, 256) layout of the same pixels
    (ops/trace_bvh.pack_pixels_np). use_dof: thin-lens primary rays, made
    here and traced by K4 (K8 without BVH arrays) instead of K1's
    in-kernel raygen. env: an environment cubemap, (6, S, S, 3) or its
    pack_cubemap_rows rows, lighting primary and bounce misses.
    alpha_rounds > 0: the stochastic alpha retrace after the primary
    trace and after every bounce trace. The ray count is pt.py's: one
    primary ray per pixel, plus every shadow ray, plus every bounce ray
    traced (pt.py:554, :804-808); retraces are not counted. Raises if a
    trace kernel overflowed its node stack (one wait for the frame's
    kernels)."""
    frame, geom = scene["frame"], scene["geom"]
    bvh = frame_bvh(frame)
    wc_min, wc_max = frame["wc_aabb_min_w"], frame["wc_aabb_max_w"]
    bounce_tr = make_bounce_tracer(geom["packed_full"], wc_min, wc_max, bvh)
    if bounce_tr is None:
        _, any_fn = make_tracer(geom["packed9"], wc_min, wc_max, bvh=bvh)
    else:
        any_fn = bounce_tr["any"]
    closest_full = _closest_full_fn(geom, frame)
    if env is not None and env.dim() != 2:
        env = pack_cubemap_rows(env)  # once a frame, not once a bounce

    def with_alpha(state, o, d, tmax, hit):
        if not alpha_rounds:
            return hit
        return alpha_retrace(scene["arena"], closest_full, alpha_rounds,
                             state, o, d, tmax, hit)

    R0 = px.shape[0]
    with gprofiler.span("primary_trace"):
        state, ray_o, ray_d = primary_streams(
            cam, px, py, width, height, frame_index, use_dof
        )
        tmax0 = torch.full((R0,), float("inf"), dtype=torch.float32,
                           device=px.device)
        if bvh is not None and not use_dof:
            cam_vec = primary_cam_vec(cam, width, height, device=px.device)
            hit = unpack_hit16(trace_primary_bvh_full(
                geom["packed_full"], *bvh, pix_cols, cam_vec,
                int(frame_index), BOUNCE_T_MIN,
            )[:R0])
        else:
            hit = closest_full(ray_o.contiguous(), ray_d.contiguous(),
                               BOUNCE_T_MIN, tmax0)
        hit = with_alpha(state, ray_o, ray_d, tmax0, hit)
        if env is not None:
            color = torch.where((hit["tri"] < 0)[:, None],
                                sample_cubemap(env, ray_d), 0.0)
        else:
            color = torch.zeros((R0, 3), dtype=torch.float32,
                                device=px.device)
        throughput = torch.ones_like(color)
        active = hit["tri"] >= 0
        with gprofiler.wait("pt.n_rays"):
            n_rays = torch.tensor(R0, dtype=torch.int64, device=px.device)
    with gprofiler.span("wavefront"):
        for b in range(max_bounces):
            (state, color, throughput, new_active, ray_o, ray_d,
             need_shadow) = _shade_and_bounce(
                scene, b, state, color, throughput, active, ray_o, ray_d,
                hit, clamp_indirect, any_fn,
            )
            n_rays = n_rays + need_shadow.sum()
            active = new_active
            if b + 1 < max_bounces:
                n_rays = n_rays + active.sum()
                tmax = torch.where(active, float("inf"), 0.0)
                o, d = ray_o.contiguous(), ray_d.contiguous()
                if bounce_tr is not None:
                    hit = bounce_tr["closest_full"](
                        o, d, LEAFMAJOR_BOUNCE_T_MIN, tmax)
                elif bvh is not None:
                    h8 = trace_closest_bvh(geom["packed_full"], *bvh, o, d,
                                           BOUNCE_T_MIN, tmax)
                    hit = attrs_from_hit_rows(geom["attr_rows"],
                                              unpack_hit8(h8))
                else:
                    hit = closest_full(o, d, BOUNCE_T_MIN, tmax)
                hit = with_alpha(state, o, d, tmax, hit)
                if env is not None:
                    sky = torch.where(
                        (active & (hit["tri"] < 0))[:, None],
                        throughput * sample_cubemap(env, ray_d), 0.0)
                    if clamp_indirect:  # every bounce trace is bounce >= 1
                        sky = torch.clamp(sky, 0.0, 2.0)
                    color = color + sky
    check_stack_overflow(px.device, "pt.stack_check")
    return color, n_rays


def pt_render_sample(scene: dict, cam: dict, width: int, height: int,
                     frame_index: int, max_bounces: int = 3,
                     use_dof: bool = False, clamp_indirect: bool = False,
                     return_stats: bool = False, env=None,
                     alpha_rounds: int = 0, *, device):
    """One full-frame 1-spp sample -> (H*W, 3) linear color in row-major
    pixel order (+ the int64 ray count when return_stats).

    scene: scene/convert.from_numpy_scene output on `device`; cam:
    camera uniforms (numpy or tensors); env, use_dof, alpha_rounds: see
    pt_trace_pixels. width must be a multiple of 16."""
    dev = check_device(scene, device)
    px, py, cols, inv16 = _pixel_layouts(width, height, str(dev))
    if env is not None:
        env = torch.as_tensor(env, dtype=torch.float32, device=dev)
    color, n_rays = pt_trace_pixels(
        scene, camera_tensors(cam, dev), px, py, cols, width, height,
        frame_index, max_bounces, clamp_indirect, use_dof, env, alpha_rounds,
    )
    color = permute16(color, inv16)
    if return_stats:
        return color, n_rays
    return color


def pt_accumulate(prev_color, prev_count, sample):
    """Running-mean accumulation (main.rgen:284-297)."""
    count = prev_count + 1.0
    return prev_color + (sample - prev_color) / count[..., None], count


def pt_entry(*, scene, cam, lut, width, height, device, exposure=1.0,
             contrast=1.0, max_bounces=3, frame_index=0, state=None,
             env=None, alpha_rounds=0, return_stats=False):
    """PT mode: render one sample, accumulate it into state (None starts
    anew), tone map. Returns (image (H, W, 3), (accumulated color, sample
    count)), and the ray count third when return_stats. env lights the
    misses (the CLI's --ibl); there is no DoF switch here, as in the JAX
    package's pt_entry (pt_render_sample takes use_dof)."""
    with gprofiler.frame("pt", frame_index):
        sample, n_rays = pt_render_sample(
            scene, cam, width, height, frame_index, max_bounces, env=env,
            alpha_rounds=alpha_rounds, return_stats=True, device=device,
        )
        sample = sample.reshape(height, width, 3)
        if state is None:
            state = (
                torch.zeros_like(sample),
                torch.zeros((height, width), dtype=torch.float32,
                            device=sample.device),
            )
        with gprofiler.span("accumulate"):
            color, count = pt_accumulate(state[0], state[1], sample)
        with gprofiler.span("tonemap"):
            img = tone_map(color, device_lut(lut, sample.device), exposure,
                           contrast)
    if return_stats:
        return img, (color, count), n_rays
    return img, (color, count)
