"""The port's entry point: a frame call on a procedural or glTF scene.

Counterpart of __graft_entry__.py `entry` (:43), which compiles
prosper_tpu's path tracer on make_test_scene at 64x64 with 2 bounces,
and of the scene setup of prosper_tpu/app/cli.py (:231-268: World ->
texture arena -> static arrays -> material tables -> camera). `entry`
builds the scene on `device` (the card unless the caller asks for the
CPU) and the camera, and returns the frame call of one mode:

- "pt": render one sample, accumulate, tone map;
- "deferred": G-buffer (with two-phase culling when use_culling),
  clustered shading, the transparent pass, the post chain (use_taa,
  use_bloom with bloom_technique "multi_res" or "fft", use_dof,
  use_particles; the JAX CLI's --taa, --bloom, --bloom-technique, --dof,
  --particles), tone map; the state threads the HiZ pyramid, the TAA
  history, the particles and the FFT bloom kernel;
- "forward": primary visibility, forward shading, the transparent pass,
  tone map, or a debug AOV (draw_type);
- "restir": ReSTIR DI (G-buffer, initial reservoirs, spatial reuse, one
  shadow ray per pixel), accumulated and tone mapped.

use_transparent and alpha_rounds default as the JAX package's CLI sets
them (prosper_tpu/app/cli.py:471, :478): the transparent pass when a
material blends, two alpha-discard rounds when one is not opaque.

    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, max_bounces=3)
    img, state, n_rays = fn(*args)            # frame 0
    img, state, n_rays = fn(args[0], args[1], 1, state)

    fn, args = entry(scene="scenes/helmet.gltf", width=1920, height=1080,
                     mode="deferred", use_culling=True)

ibl=True (the CLI's --ibl, cli.py:321-329) builds the environment
procedural_sky(env_res) and its IBL maps (ops/ibl.build_ibl, start-up
work) on the device: the path tracer takes the environment for its
misses, the deferred frame the IBL term, the skybox and the transparent
pass's IBL. lut_path names a Tony McMapface DDS (the reference's
res/texture/tony_mc_mapface.dds) for the display transform; without it
the synthetic LUT stands in.

    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, mode="deferred", use_culling=True,
                     scatter_lights=1024, ibl=True, use_taa=True,
                     use_bloom=True, use_dof=True, use_particles=True)

A scene given as a path to a .gltf or .glb file is loaded through
scene/world.py `World` (its caches next to the file) at time 0, its images
mipped into the texture arena (scene/textures.py, at most 2048 texels a
side, as the JAX CLI's default), with the scene's first camera (else
the default camera) and its KHR_lights_punctual lights.

    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, mode="deferred", use_culling=True,
                     scatter_lights=1024)
    img, state, drawn_meshlets = fn(*args)

    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, mode="forward", scatter_lights=1024,
                     blend_every=8, mask_every=8)
    img, state, covered_pixels = fn(*args)

    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, mode="restir", scatter_lights=1024)
    img, state, shadow_rays = fn(*args)       # frame 0
    img, state, shadow_rays = fn(args[0], args[1], 1, state)

The shadow rays' any-hit kernel follows config.policy.any_tracer on a
frame with BVH arrays ("stack": K3, "dense": K10); bvh=False takes the
flat kernels in every mode (K7 for shadow rays).
config.policy.bounce_tracer = "leafmajor", read at every frame, sends
the path tracer's shadow and bounce rays and ReSTIR's shadow rays on a
frame with BVH arrays through the leaf-major hybrid instead: K14's pair
blocks for rays with few candidate clusters, K3 (shadow) and K2
(bounce) for the rest; primary rays stay on K1.

    from prosper_tpu_torch import config
    config.policy.bounce_tracer = "leafmajor"
    fn, args = entry(scene="plate", n_clusters=2048, width=1920,
                     height=1080, max_bounces=3)
"""

from __future__ import annotations

import torch

from .ops.ibl import build_ibl, procedural_sky
from .ops.tonemap import load_tony_mc_mapface, pack_lut_quads, synthetic_lut
from .render.deferred import deferred_entry
from .render.forward import forward_entry
from .render.pt import pt_entry
from .render.restir import restir_entry
from .scene.convert import camera_tensors, from_numpy_scene
from .testing import make_plate_scene, make_test_scene

SCENES = {"test": make_test_scene, "plate": make_plate_scene}
MAX_TEXTURE_DIM = 2048  # prosper_tpu/app/cli.py --max-texture-dim


def gltf_scene(path: str, use_cache: bool = True):
    """(static, frame, arena, cam_fn) of a glTF file through World: the
    numpy dicts from_numpy_scene takes, as the procedural scenes give
    them."""
    from .scene.textures import build_texture_arena
    from .scene.world import World

    world = World(path, use_cache=use_cache)
    arena = build_texture_arena(world.doc, max_dim=MAX_TEXTURE_DIM,
                                scene_path=path if use_cache else None)

    def cam_fn(width: int, height: int) -> dict:
        return world.make_camera((width, height)).uniforms()

    return (world.static_scene_arrays(), world.frame_arrays(0.0),
            arena.uniforms(), cam_fn)


def entry(device="cuda", scene: str = "test", n_clusters: int = 4,
          width: int = 64, height: int = 64, max_bounces: int = 2,
          seed: int = 0, mode: str = "pt", use_culling: bool = False,
          scatter_lights: int = 0, blend_every: int = 0,
          mask_every: int = 0, bvh: bool = True,
          use_transparent: bool | None = None,
          alpha_rounds: int | None = None, draw_type: int = 0,
          use_taa: bool = False, use_bloom: bool = False,
          bloom_technique: str = "multi_res", use_dof: bool = False,
          use_particles: bool = False, ibl: bool = False, env_res: int = 256,
          lut_path: str | None = None):
    """Returns (fn, example_args) with fn(scene, cam, frame_index,
    state=None) -> (image (H, W, 3), state, stat) and example_args =
    (scene tensors, camera tensors, 0). stat is the ray count in "pt"
    mode, the number of drawn meshlets in "deferred" mode (every cluster
    without culling), the number of pixels with an opaque surface in
    "forward" mode, and in "restir" mode the number of pixels whose final
    reservoir holds a light in front of their surface, one shadow ray
    each.

    scene: "test", "plate", or the path of a .gltf or .glb file (then
    n_clusters and seed are not read). Plate scene only: scatter_lights
    > 0 scatters that many point lights, blend_every and mask_every give
    plates blend and mask materials (testing.make_plate_scene).
    bvh=False leaves the BVH node arrays out of the frame, so every trace
    takes the flat kernels. The post flags apply to "deferred" mode, ibl
    to "pt" and "deferred"; other modes refuse them."""
    if mode not in ("pt", "deferred", "forward", "restir"):
        raise ValueError(f"unknown mode {mode!r}")
    post = [k for k, on in (("use_taa", use_taa), ("use_bloom", use_bloom),
                            ("use_dof", use_dof),
                            ("use_particles", use_particles),
                            ("ibl", ibl and mode not in ("pt", "deferred")))
            if on]
    if post and mode != "deferred":
        raise ValueError(f"{', '.join(post)}: not an option of mode "
                         f"{mode!r}")
    if ibl and env_res < 2:
        raise ValueError(f"env_res must be >= 2, got {env_res}")
    extra = {}
    if scatter_lights or blend_every or mask_every:
        if scene != "plate":
            raise ValueError("scatter_lights, blend_every and mask_every "
                             "need the plate scene")
        extra = {"scatter_lights": scatter_lights,
                 "blend_every": blend_every, "mask_every": mask_every}
    if scene.endswith((".gltf", ".glb")):
        static, frame, arena, cam_fn = gltf_scene(scene)
    else:
        static, frame, arena, cam_fn = SCENES[scene](n_clusters, seed,
                                                     **extra)
    if not bvh:
        frame = {k: v for k, v in frame.items()
                 if k not in ("bvh_bounds", "bvh_meta", "bvh_nodes8")}
    alpha_mode = static["materials"]["alpha_mode"]
    if use_transparent is None:
        use_transparent = bool((alpha_mode == 2).any())
    if alpha_rounds is None:
        alpha_rounds = 2 if bool((alpha_mode != 0).any()) else 0
    scene_t = from_numpy_scene(static, frame, arena, device)
    cam = camera_tensors(cam_fn(width, height), device)
    # the display LUT of the reference is not in the repo: a synthetic one
    # unless lut_path names it
    lut = torch.as_tensor(load_tony_mc_mapface(lut_path) if lut_path
                          else pack_lut_quads(synthetic_lut()), device=device)
    env = ibl_data = None
    if ibl:
        env = procedural_sky(env_res, device=device)
        if mode == "deferred":  # the path tracer reads the environment alone
            ibl_data = build_ibl(env)
            ibl_data["env"] = env

    if mode == "pt":
        def fn(scene_t, cam, frame_index, state=None):
            return pt_entry(
                scene=scene_t, cam=cam, lut=lut, width=width, height=height,
                device=device, max_bounces=max_bounces,
                frame_index=frame_index, state=state, return_stats=True,
                alpha_rounds=alpha_rounds, env=env,
            )
    elif mode == "deferred":
        n_all = torch.tensor(scene_t["geom"]["packed_full"].shape[0])

        def fn(scene_t, cam, frame_index, state=None):
            img, state = deferred_entry(
                scene=scene_t, cam=cam, lut=lut, width=width, height=height,
                device=device, state=state, use_culling=use_culling,
                use_transparent=use_transparent, alpha_rounds=alpha_rounds,
                frame_index=frame_index, use_taa=use_taa,
                use_bloom=use_bloom, bloom_technique=bloom_technique,
                use_dof=use_dof, use_particles=use_particles,
                ibl_data=ibl_data,
            )
            return img, state, state["draw_stats"].get("drawn_meshlets",
                                                       n_all)
    elif mode == "restir":
        def fn(scene_t, cam, frame_index, state=None):
            return restir_entry(
                scene=scene_t, cam=cam, lut=lut, width=width, height=height,
                device=device, frame_index=frame_index, state=state,
                alpha_rounds=alpha_rounds, return_stats=True,
            )
    else:
        def fn(scene_t, cam, frame_index, state=None):
            img, state = forward_entry(
                scene=scene_t, cam=cam, lut=lut, width=width, height=height,
                device=device, state=state, draw_type=draw_type,
                use_transparent=use_transparent, alpha_rounds=alpha_rounds,
                frame_index=frame_index,
            )
            return img, state, state["covered_pixels"]

    return fn, (scene_t, cam, 0)
