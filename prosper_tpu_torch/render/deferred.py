"""Deferred shading: G-buffer + clustered lights + the post chain ->
display image.

Counterpart of prosper_tpu/render/deferred.py `shade_deferred` (:22),
`render_deferred` (:108) and `deferred_entry` (:287),
deferred_shading.comp of the reference and the pass order of
Renderer.cpp:485-584: the G-buffer (lodBias -1 under TAA), the
directional light, clustered point and spot lights through the tile
kernel (K5, ops/shade_tiles.py) and image-based lighting (ops/ibl.py)
when ibl_data is given; then the skybox on pixels without a surface
(ibl_data["env"]), the transparent pass (render/transparent.py), bloom
(ops/bloom.py, multi_res or fft), particles (ops/particles.py, one
1/60 s step, drawn before TAA), TAA (ops/taa.py; the first frame's
history is the frame itself), depth of field (ops/dof.py) and the tone
map. The state threads the preserve()d resources from frame to frame:
the HiZ pyramid of the culled G-buffer, the TAA history, the particle
pool, the FFT bloom kernel (made once) and the depth.

The passes run under gprofiler.span scopes (torch.profiler.
record_function ranges, and host spans while recording) named as the
JAX package's jax.named_scope passes (deferred.py:155-274): gbuffer,
light_clustering (the tile light lists, made here and handed to the
shading), shading, skybox, transparent, bloom, particles, taa, dof and
tonemap, which utils/profiler.profile_passes reads; deferred_entry is
the frame span.
"""

from __future__ import annotations

import torch

from ..mathx.packing import signed_oct_decode
from ..ops.bloom import bloom_fft, bloom_multi_res, fft_dim, generate_kernel
from ..ops.dof import depth_of_field
from ..ops.ibl import eval_ibl, sample_cubemap
from ..ops.particles import (
    init_state,
    render_particles,
    simulate,
    spawn_emitters,
)
from ..ops.rays import pinhole_rays
from ..ops.shade_tiles import build_tile_light_lists
from ..ops.taa import taa_resolve
from ..ops.tonemap import device_lut, tone_map
from ..scene.convert import camera_tensors, check_device
from ..utils.profiler import gprofiler
from .gbuffer import render_gbuffer
from .shading import has_local_lights, shade_direct
from .transparent import transparent_pass

BLOOM_TECHNIQUES = ("multi_res", "fft")
PARTICLE_DT = 1.0 / 60.0


def shade_deferred(gbuf: dict, lights: dict, cam: dict, width: int,
                   height: int, ibl_data: dict | None = None,
                   light_lists=None, y_offset: int = 0,
                   full_height: int | None = None):
    """Clustered deferred shading of the flat G-buffer (+ IBL) -> (R, 3)
    linear color, zero where no surface was hit. light_lists: the tile
    lists, when the caller made them. y_offset, full_height: the
    G-buffer is `height` rows from absolute row y_offset (a multiple of
    32) of a full_height frame; the froxel rows stay absolute, so a band
    shades the full frame's light set (render/distributed.py)."""
    normal = signed_oct_decode(gbuf["normal_metallic"][:, :3])
    pos = gbuf["position_ws"]
    inv_view = cam["eye"] - pos
    inv_view = inv_view / torch.clamp_min(
        (inv_view * inv_view).sum(-1, keepdim=True).sqrt(), 1e-20)
    surface = {
        "position_ws": pos,
        "normal_ws": normal,
        "inv_view_ray": inv_view,
        "albedo": gbuf["albedo_roughness"][:, :3],
        "roughness": gbuf["albedo_roughness"][:, 3],
        "metallic": gbuf["normal_metallic"][:, 3],
        "NoV": torch.clamp((normal * inv_view).sum(-1), 0.0, 1.0),
    }
    color = shade_direct(surface, lights, cam, gbuf["z_cam"], gbuf["valid"],
                         width, height, light_lists, y_offset, full_height)
    if ibl_data is not None:
        color = torch.where(gbuf["valid"][:, None],
                            color + eval_ibl(surface, ibl_data), 0.0)
    return color


def skybox(env, cam: dict, width: int, height: int, y_offset: int = 0,
           full_height: int | None = None) -> torch.Tensor:
    """The environment along each pixel center's view ray, (R, 3)
    row-major (the SkyboxRenderer's pass); y_offset, full_height: the
    band of `height` rows from absolute row y_offset of a full_height
    frame."""
    dev = cam["eye"].device
    full_h = height if full_height is None else full_height
    ys = (torch.arange(height, dtype=torch.float32, device=dev) + y_offset
          + 0.5) / full_h
    xs = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5) / width
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    _, vd = pinhole_rays(cam, torch.stack([gx, gy], -1).reshape(-1, 2))
    return sample_cubemap(env, vd)


def render_deferred(scene: dict, cam: dict, lut, width: int, height: int,
                    exposure: float = 1.0, contrast: float = 1.0,
                    use_taa: bool = False, use_bloom: bool = False,
                    use_dof: bool = False, taa_history=None,
                    ibl_data: dict | None = None, use_culling: bool = False,
                    prev_hiz: list | None = None,
                    use_transparent: bool = False,
                    use_particles: bool = False,
                    bloom_technique: str = "multi_res", bloom_kernel=None,
                    particle_state: dict | None = None,
                    alpha_rounds: int = 0, aniso_taps: int = 1,
                    frame_index: int = 0):
    """One deferred frame and its post chain, in the reference's pass
    order -> (display image (H, W, 3), aux dict: taa_history, particles,
    depth (H, W), the fresh hiz, draw_stats)."""
    if bloom_technique not in BLOOM_TECHNIQUES:
        raise ValueError(f"unknown bloom_technique {bloom_technique!r}; "
                         f"expected one of {BLOOM_TECHNIQUES}")
    lights = scene["frame"]["lights"]
    with gprofiler.span("gbuffer"):
        gbuf = render_gbuffer(scene, cam, width, height,
                              use_culling=use_culling, prev_hiz=prev_hiz,
                              lod_bias=-1.0 if use_taa else 0.0,
                              alpha_rounds=alpha_rounds,
                              aniso_taps=aniso_taps)
    with gprofiler.span("light_clustering"):
        light_lists = (build_tile_light_lists(cam, lights, width, height)
                       if has_local_lights(lights) else None)
    with gprofiler.span("shading"):
        color = shade_deferred(gbuf, lights, cam, width, height, ibl_data,
                               light_lists)
    if ibl_data is not None and "env" in ibl_data:
        with gprofiler.span("skybox"):
            color = torch.where(gbuf["valid"][:, None], color,
                                skybox(ibl_data["env"], cam, width, height))
    hdr = color.reshape(height, width, 3)
    depth = gbuf["depth"].reshape(height, width)
    if use_transparent:
        # ForwardRenderer::recordTransparent's slot (Renderer.cpp:494-500)
        with gprofiler.span("transparent"):
            hdr = transparent_pass(scene, cam, hdr, gbuf["z_cam"], width,
                                   height, ibl_data)
    if use_bloom:
        with gprofiler.span("bloom"):
            if bloom_technique == "fft":
                hdr = bloom_fft(hdr, kernel_image=bloom_kernel)
            else:
                hdr = bloom_multi_res(hdr)
    new_particles = None
    if use_particles:
        with gprofiler.span("particles"):
            new_particles = simulate(particle_state, PARTICLE_DT,
                                     frame_index)
            hdr = render_particles(new_particles, hdr, depth, cam)
    new_history = None
    if use_taa:
        with gprofiler.span("taa"):
            velocity = gbuf["velocity"].reshape(height, width, 2)
            prev = hdr if taa_history is None else taa_history
            hdr = taa_resolve(hdr, prev, velocity, depth)
        new_history = hdr
    if use_dof:
        with gprofiler.span("dof"):
            view_depth = torch.clamp_min(
                -gbuf["z_cam"].reshape(height, width), 1e-3)
            hdr = depth_of_field(hdr, view_depth, cam)
    with gprofiler.span("tonemap"):
        img = tone_map(hdr, lut, exposure, contrast)
    aux = {
        "taa_history": new_history,
        "particles": new_particles,
        "depth": depth,
        "hiz": gbuf["hiz"],
        "draw_stats": gbuf["draw_stats"],
    }
    return img, aux


def spawn_scene_particles(lights: dict) -> dict:
    """The init pass: one emitter at each point light, normal +y (one at
    the origin without point lights), as the JAX package's
    deferred_entry spawns them (deferred.py:313-331)."""
    n = int(lights["point_count"])
    dev = lights["point_position"].device
    if n == 0:
        pos = torch.zeros((1, 3), dtype=torch.float32, device=dev)
        nrm = torch.tensor([[0.0, 1.0, 0.0]], device=dev)
    else:
        pos = lights["point_position"][:n].to(torch.float32)
        nrm = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        nrm[:, 1] = 1.0
    return spawn_emitters(init_state(device=dev), pos, nrm)


def deferred_entry(*, scene, cam, lut, width, height, device="cuda",
                   exposure=1.0, contrast=1.0, state=None, use_taa=False,
                   use_bloom=False, use_dof=False, use_transparent=False,
                   use_particles=False, bloom_technique="multi_res",
                   ibl_data=None, use_culling=False, alpha_rounds=0,
                   aniso_taps=1, frame_index=0):
    """Deferred mode: one frame -> (image (H, W, 3), state) on `device`
    (the card unless the caller asks for the CPU). `state` (None starts
    anew) carries the preserve()d resources: taa_history, particles
    (spawned from the scene's point lights on the first frame that asks
    for them), bloom_kernel (made once for the FFT bloom), depth, the
    HiZ pyramid that the next frame's phase-1 cull tests against, and
    the frame's draw stats. frame_index seeds the particles' noise."""
    with gprofiler.frame("deferred", frame_index):
        dev = check_device(scene, device)
        state = dict(state) if state else {}
        lut = device_lut(lut, dev)
        particles = state.get("particles")
        if use_particles and particles is None:
            particles = spawn_scene_particles(scene["frame"]["lights"])
        bloom_kernel = state.get("bloom_kernel")
        if use_bloom and bloom_technique == "fft" and bloom_kernel is None:
            # the kernel's extent is bloom_fft's half-resolution FFT extent
            bloom_kernel = generate_kernel(
                fft_dim(max((height + 1) // 2, 1), max((width + 1) // 2, 1)),
                device=dev)
        img, aux = render_deferred(
            scene, camera_tensors(cam, dev), lut, width, height, exposure,
            contrast, use_taa=use_taa, use_bloom=use_bloom, use_dof=use_dof,
            taa_history=state.get("taa_history"), ibl_data=ibl_data,
            use_culling=use_culling, prev_hiz=state.get("hiz"),
            use_transparent=use_transparent, use_particles=use_particles,
            bloom_technique=bloom_technique, bloom_kernel=bloom_kernel,
            particle_state=particles, alpha_rounds=alpha_rounds,
            aniso_taps=aniso_taps, frame_index=frame_index,
        )
    state.update(aux)
    state["bloom_kernel"] = bloom_kernel
    return img, state
