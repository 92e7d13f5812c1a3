"""Headless CLI of the port: render frames of a glTF scene on the card.

Counterpart of prosper_tpu/app/cli.py (`build_parser`,
`_load_toml_defaults`, `_apply_policy`, `_source_mtimes`,
`_draw_type_index`, `main`), the replacement of the reference's windowed
App (main.cpp:46-130: a positional scene file and options, a TOML config
merged under the flags; Renderer.hpp:107-117's mode toggles as --mode
and flags). The same subcommand, flags, defaults and TOML merge, with
the port's own:

- --platform gpu (the default) renders on the card and exits non-zero
  when torch sees none; --platform cpu renders on the CPU (every kernel
  wrapper then runs its plain version). Nothing falls back from one to
  the other, and a kernel that fails to build or launch stops the run.
- --devices N > 1 renders pt, restir and deferred frames in pixel bands
  over N ranks that this process starts (render/distributed.py,
  torch.multiprocessing spawn): NCCL ranks, one card each, under
  --platform gpu, which exits 2 where torch sees fewer than N cards;
  gloo ranks on the CPU under --platform cpu, where N is not bounded,
  as the JAX package's virtual CPU devices are not. Each rank loads the
  scene file; rank 0 logs and writes the images. Another mode exits 2;
  --taa, --bloom, --dof, --particles and --culling are dropped with the
  JAX CLI's log line, and --streaming with one of its own (each rank
  would adopt the streamed meshes at another frame). Nothing falls back
  to fewer ranks or to the CPU.
- The JAX CLI takes its default scene (FlightHelmet) and its display LUT
  (Tony McMapface) from the reference checkout at a fixed path; the
  port takes the same files (DEFAULT_SCENE_REL, TONY_LUT_REL) from the
  checkout that $PROSPER_REFERENCE names. Without one a scene must be
  given and the synthetic LUT of entry.py stands in; the log says which
  LUT it took.
- --restir-shadow-tile is read and ignored: the port's ReSTIR traces its
  shadow rays in 16x16 pixel blocks without the JAX package's packets.
- --watch re-executes this module when a source of the package changes,
  the .cu and .cuh kernel sources included: ops/cuda_build.py rebuilds a
  kernel whose source hash changed (the reference's shader hot reload).

The frame loop: the World, then the texture arena (the streaming arena
under --streaming), then the static tensors once; each frame
frame_arrays(t), the geometry through ops/trace.GeometryCache, the camera
(orbit, TAA jitter), the mode's frame call from render/frame.py with the
options that mode has (the JAX CLI's: PT ignores --dof; the transparent
pass and two alpha rounds follow the materials), then Camera.end_frame.
Two frames are in flight: a frame's end is a CUDA event, waited for when
a third frame would start (MAX_FRAMES_IN_FLIGHT of the reference's
Utils.hpp:15); uploads between frames are non-blocking copies from
pinned memory.

Usage:
  python -m prosper_tpu_torch.app.cli render SCENE.gltf --mode deferred \\
      --width 1920 --height 1080 --frames 8 --out frame.png
  python -m prosper_tpu_torch.app.cli render SCENE.gltf --platform cpu \\
      --mode pt --width 64 --height 64
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from collections import Counter, deque

import numpy as np

# The reference renderer's checkout (sndels/prosper), where the
# environment names one: the JAX CLI's default scene and display LUT are
# these files in it.
REFERENCE_ENV = "PROSPER_REFERENCE"
DEFAULT_SCENE_REL = "res/glTF/FlightHelmet/glTF/FlightHelmet.gltf"
TONY_LUT_REL = "res/texture/tony_mc_mapface.dds"

# a mode flag -> the modes whose frame call reads it
_MODE_FLAGS = {
    "taa": ("deferred",), "bloom": ("deferred",), "dof": ("deferred",),
    "particles": ("deferred",), "culling": ("deferred",),
    "autofocus": ("deferred",), "ibl": ("pt", "deferred"),
}
# the flags --devices N > 1 drops, as the JAX CLI does (cli.py:298-311)
_SHARDED_DROPS = ("taa", "bloom", "dof", "particles", "culling")


def _load_toml_defaults(path: str | None) -> dict:
    if not path:
        return {}
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)


def reference_file(rel: str) -> str | None:
    """rel inside the reference checkout that $PROSPER_REFERENCE names, or
    None when it names none."""
    root = os.environ.get(REFERENCE_ENV)
    return os.path.join(root, rel) if root else None


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="prosper_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)
    r = sub.add_parser("render", help="render frames of a glTF scene")
    r.add_argument("scene", nargs="?",
                   default=reference_file(DEFAULT_SCENE_REL),
                   help="glTF file (default: the reference checkout's "
                   "FlightHelmet, when $PROSPER_REFERENCE names one)")
    r.add_argument("--config", help="TOML config file (CLI flags win)")
    r.add_argument(
        "--mode",
        default="forward",
        choices=["forward", "pt", "deferred", "restir"],
    )
    r.add_argument("--width", type=int, default=1920)
    r.add_argument("--height", type=int, default=1080)
    r.add_argument("--frames", type=int, default=1)
    r.add_argument("--time", type=float, default=0.0, help="animation time (s)")
    r.add_argument("--animate", action="store_true", help="advance time per frame")
    r.add_argument("--exposure", type=float, default=1.0)
    r.add_argument("--contrast", type=float, default=1.0)
    r.add_argument("--max-bounces", type=int, default=3)
    r.add_argument("--taa", action="store_true", help="TAA resolve (deferred mode)")
    r.add_argument("--ibl", action="store_true", help="IBL + procedural sky env")
    r.add_argument("--env-res", type=int, default=256,
                   help="procedural sky cubemap face resolution")
    r.add_argument("--culling", action="store_true",
                   help="two-phase meshlet culling (deferred)")
    r.add_argument("--bloom", action="store_true", help="bloom (deferred mode)")
    r.add_argument(
        "--bloom-technique",
        default="multi_res",
        choices=["multi_res", "fft"],
        help="bloom technique (Bloom.hpp:56-70)",
    )
    r.add_argument("--dof", action="store_true",
                   help="depth of field (deferred mode)")
    r.add_argument(
        "--autofocus",
        action="store_true",
        help="DoF focus from a frame-late center depth pick (App.cpp:607-631)",
    )
    r.add_argument(
        "--particles",
        action="store_true",
        help="toy particle system, drawn pre-TAA (Renderer.cpp:531-538)",
    )
    r.add_argument(
        "--draw-type",
        default="default",
        help="debug AOV (forward mode): primitive_id|meshlet_id|mesh_id|"
        "material_id|position|shading_normal|texcoord0|albedo|roughness|metallic",
    )
    r.add_argument(
        "--aniso-taps", type=int, default=1, metavar="N",
        help="anisotropic material filtering: N trilinear taps along the "
        "uv-space major footprint axis (1 = trilinear)",
    )
    r.add_argument("--dump-debug", default=None, metavar="PATH",
                   help="TextureDebug analog: also dump the last frame "
                   "(PATH.npy raw, PATH normalised PNG)")
    r.add_argument("--out", default="out/frame.png")
    r.add_argument("--max-texture-dim", type=int, default=2048)
    r.add_argument("--orbit-camera", action="store_true",
                   help="orbit the camera around the scene per frame")
    r.add_argument("--scatter-lights", type=int, default=0, metavar="N",
                   help="scatter N random point emitters (many-light testing)")
    r.add_argument("--streaming", action="store_true",
                   help="asynchronous asset streaming (deferred loading)")
    r.add_argument("--no-cache", action="store_true", help="bypass asset caches")
    r.add_argument(
        "--instance-grid", type=int, default=1, metavar="N",
        help="replicate the scene on an NxN ground grid (scale testing)",
    )
    r.add_argument("--fps-limit", type=float, default=0.0,
                   help="cap the frame rate (0 = off)")
    r.add_argument("--profile", action="store_true",
                   help="per-frame host scopes, then the per-pass device "
                   "table and the launches of one steady-state frame")
    r.add_argument(
        "--profile-device",
        action="store_true",
        help="trace the last frame again and print the top device kernels",
    )
    r.add_argument(
        "--platform", default="gpu", choices=["gpu", "cpu"],
        help="gpu: the CUDA kernels on the card (exits non-zero without "
        "one); cpu: the kernels' plain versions on the CPU",
    )
    r.add_argument(
        "--devices", type=int, default=0, metavar="N",
        help="shard pt, restir and deferred frames over N ranks in pixel "
        "bands (gpu: N cards, NCCL; cpu: N gloo processes); 0 or 1 = one "
        "device",
    )
    r.add_argument(
        "--watch",
        action="store_true",
        help="hot reload: after rendering, poll the package's sources "
        "(.py, .cpp, .cu, .cuh) and render again when one changes",
    )
    # kernel-policy knobs (config.KernelPolicy holds the defaults)
    r.add_argument(
        "--any-tracer", choices=("stack", "dense"), default=None,
        help="any-hit (shadow) BVH kernel: stack (K3) or dense (K10) "
        "(default: see prosper_tpu_torch/config.py)",
    )
    r.add_argument(
        "--bounce-tracer", choices=("packet", "leafmajor"), default=None,
        help="incoherent bounce/shadow tracer family (default: packet)",
    )
    r.add_argument(
        "--restir-shadow-tile", type=int, default=None, metavar="N",
        help="rays/packet of the JAX package's ReSTIR shadow batch; the "
        "port traces in 16x16 pixel blocks and ignores it",
    )
    r.add_argument(
        "--bounce-tap-mip", type=int, default=None, metavar="K",
        help="texture mip for secondary-bounce surface taps in PT "
        "(0 = base mip; default: see prosper_tpu_torch/config.py)",
    )
    return p


def _apply_policy(args) -> None:
    """Fold the kernel-policy flags into config.policy, the one runtime
    configuration surface (main.cpp:46-130 analog). The port reads the
    policy at every frame."""
    from .. import config
    from ..utils.logger import log_warn

    if args.any_tracer is not None:
        config.policy.any_tracer = args.any_tracer
    if args.bounce_tracer is not None:
        config.policy.bounce_tracer = args.bounce_tracer
    if args.bounce_tap_mip is not None:
        config.policy.bounce_tap_mip = int(args.bounce_tap_mip)
    if args.restir_shadow_tile is not None:
        log_warn("--restir-shadow-tile %s ignored: the port traces ReSTIR's "
                 "shadow rays in 16x16 pixel blocks", args.restir_shadow_tile)


def _source_mtimes(root: str) -> dict:
    """mtime snapshot of the package's sources, the kernels' CUDA sources
    included (the recursive res/shader scan of App.cpp:248-277)."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                p = os.path.join(dirpath, f)
                try:
                    out[p] = os.stat(p).st_mtime
                except OSError:
                    pass
    return out


def _draw_type_index(name: str) -> int:
    from ..render.debug import DRAW_TYPE_NAMES

    return DRAW_TYPE_NAMES.index(name.lower())


def _merge_toml(args, argv: list[str]) -> None:
    """TOML values replace the parser's defaults, not the flags given."""
    for k, v in _load_toml_defaults(args.config).items():
        k = k.replace("-", "_")
        if hasattr(args, k) and "--" + k.replace("_", "-") not in argv:
            setattr(args, k, v)


def _display_lut():
    """(packed LUT, its name): the reference checkout's Tony McMapface
    when $PROSPER_REFERENCE names a checkout that has it, else the
    synthetic LUT."""
    from ..ops.tonemap import (
        load_tony_mc_mapface,
        pack_lut_quads,
        synthetic_lut,
    )

    path = reference_file(TONY_LUT_REL)
    if path and os.path.exists(path):
        return load_tony_mc_mapface(path), path
    return pack_lut_quads(synthetic_lut()), "the synthetic LUT"


def _scatter_lights(world, n: int) -> None:
    """Scatter n random point emitters over the scene bounds (the
    reference's commented-out light scattering, WorldData.cpp:213)."""
    rng = np.random.default_rng(0)
    n = min(n, 1024)
    lo = world.wc_aabb_min_obj.min(axis=0)
    hi = world.wc_aabb_max_obj.max(axis=0)
    world.lights.point_position[:n] = rng.uniform(lo, hi, (n, 3))
    world.lights.point_radiance[:n] = rng.uniform(0.05, 0.5, (n, 3))
    world.lights.point_radius[:n] = float(np.linalg.norm(hi - lo))
    world.lights.point_count = n


def _orbit(cam_obj, base_eye, base_target, f: int, frames: int) -> None:
    from ..scene.camera import CameraTransform

    ang = 2.0 * np.pi * f / max(frames, 1)
    rot = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    cam_obj.look_at(CameraTransform(
        eye=base_target + rot @ (base_eye - base_target),
        target=base_target, up=np.array([0, 1, 0], np.float32)))


def _mode_options(args, world, env, ibl_data) -> dict:
    """The options of the mode's frame call, as the JAX CLI passes them:
    the transparent pass when a material blends, two alpha-discard rounds
    when one is not opaque."""
    alpha_mode = world.materials.alpha_mode
    alpha_rounds = 2 if bool((alpha_mode != 0).any()) else 0
    use_transparent = bool((alpha_mode == 2).any())
    if args.mode == "pt":
        return {"max_bounces": args.max_bounces, "env": env,
                "alpha_rounds": alpha_rounds}
    if args.mode == "deferred":
        return {"use_taa": args.taa, "use_bloom": args.bloom,
                "use_dof": args.dof, "use_particles": args.particles,
                "use_transparent": use_transparent,
                "bloom_technique": args.bloom_technique,
                "ibl_data": ibl_data, "use_culling": args.culling,
                "alpha_rounds": alpha_rounds, "aniso_taps": args.aniso_taps}
    if args.mode == "forward":
        return {"draw_type": _draw_type_index(args.draw_type),
                "use_transparent": use_transparent,
                "alpha_rounds": alpha_rounds, "aniso_taps": args.aniso_taps}
    return {"alpha_rounds": alpha_rounds}


def _short(kernel: str) -> str:
    """A kernel's name without its return type and argument list, cut to
    60 characters (the names it merges are counted together)."""
    name = kernel.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:60]


def _sharded_checks(args) -> int:
    """The JAX CLI's checks of --devices N > 1 (prosper_tpu/app/cli.py:
    274-315) -> an exit code, 0 to go on; drops the flags the sharded
    modes do not take, with its log line."""
    import torch

    from ..render.distributed import SHARDED_MODES
    from ..utils.logger import log_error, log_info

    n = args.devices
    # N gloo ranks on the CPU are always possible, as JAX's virtual CPU
    # devices are; on the card each NCCL rank takes a card of its own
    have = torch.cuda.device_count() if args.platform == "gpu" else n
    if have < n:
        log_error("--devices %d but torch sees %d CUDA devices", n, have)
        return 2
    if args.mode not in SHARDED_MODES:
        log_error("--devices does not support mode %r (sharded modes: %s)",
                  args.mode, sorted(SHARDED_MODES))
        return 2
    dropped = [f"--{flag}" for flag in _SHARDED_DROPS if getattr(args, flag)]
    if dropped:
        log_info("sharded mode ignores post/culling flags: %s",
                 " ".join(dropped))
    if args.streaming:
        log_info("sharded mode loads the scene whole: --streaming ignored")
    for flag in _SHARDED_DROPS + ("streaming",):
        setattr(args, flag, False)
    return 0


def main(argv: list[str] | None = None) -> int:
    """Run the command line (argv without the program name; None: the
    process's); returns the exit code."""
    argv_list = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv_list)
    _merge_toml(args, argv_list)

    from ..utils.logger import log_error

    if args.scene is None:
        log_error("no scene: give a glTF file, or name the reference "
                  "checkout in $%s", REFERENCE_ENV)
        return 2
    if args.frames < 1:
        log_error("--frames must be >= 1, got %d", args.frames)
        return 2
    if args.ibl and args.env_res < 2:
        log_error("--env-res must be >= 2, got %d", args.env_res)
        return 2
    if args.devices > 1:
        rc = _sharded_checks(args)
        if rc:
            return rc

    import torch

    if args.platform == "gpu" and not torch.cuda.is_available():
        log_error("--platform gpu: torch sees no CUDA device (pass "
                  "--platform cpu to render on the CPU)")
        return 1
    if args.devices > 1:
        from ..render.distributed import run_ranks

        n = args.devices
        gpu = args.platform == "gpu"
        rc = run_ranks(
            _render_rank, n, args, backend="nccl" if gpu else "gloo",
            devices=[f"cuda:{r}" for r in range(n)] if gpu else ["cpu"] * n,
            threads=None if gpu else max(1, torch.get_num_threads() // n),
        )[0]
    else:
        rc = _render(args, torch.device("cuda" if args.platform == "gpu"
                                        else "cpu"))
    if args.watch:
        # the hot-reload loop: wait for a source edit, then run this render
        # again in a new process (App::recompileShaders, App.cpp:235-307)
        from ..utils.logger import log_info

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        snap = _source_mtimes(pkg_root)
        log_info("watching %s for changes...", pkg_root)
        while _source_mtimes(pkg_root) == snap:
            time.sleep(0.5)
        log_info("source changed; reloading")
        os.execv(sys.executable,
                 [sys.executable, "-m", "prosper_tpu_torch.app.cli"]
                 + argv_list)
    return rc


def _render_rank(rank, group, device, args) -> int:
    """A rank of the sharded CLI: the frame loop over the group, quiet
    but for rank 0, which logs and writes the images."""
    import logging

    from ..utils import logger  # noqa: F401  (sets up the logger first)

    if rank:
        logging.getLogger("prosper_tpu_torch").setLevel(logging.WARNING)
    return _render(args, device, group)


def _render(args, dev, group=None) -> int:
    """The frame loop on device dev: one rank's frames (group None), or
    this rank's part of frames sharded over group -> the exit code."""
    import torch

    from ..utils.logger import log_info

    _apply_policy(args)

    from ..io.image import write_png
    from ..ops.trace import GeometryCache
    from ..render.frame import render_modes
    from ..render.readback import TextureReadback, focus_from_depth
    from ..scene.convert import (
        arena_tensors,
        camera_tensors,
        frame_tensors,
        static_tensors,
    )
    from ..scene.textures import (
        arena_write,
        build_streaming_arena,
        build_texture_arena,
    )
    from ..scene.world import World
    from ..utils.profiler import gprofiler
    from ..utils.timer import Timer

    ignored = [f"--{flag}" for flag, modes in _MODE_FLAGS.items()
               if getattr(args, flag) and args.mode not in modes]
    if ignored:
        log_info("mode %s ignores %s", args.mode, " ".join(ignored))

    timer = Timer()
    # --profile: World's load recorded as a frame of its own, whose host
    # spans (world.meshlets, one a primitive) print before the frames'
    with gprofiler.recording(args.profile):
        gprofiler.start_frame()
        world = World(args.scene, use_cache=not args.no_cache,
                      streaming=args.streaming,
                      instance_grid=args.instance_grid)
        load = gprofiler.end_frame()
    if load is not None and (group is None
                             or torch.distributed.get_rank(group) == 0):
        print("\n".join(["scene load:"]
                        + load.report().table().splitlines()[1:]))
    scene_path = None if args.no_cache else args.scene
    texture_jobs = []
    if args.streaming:
        # the layout from the image headers; the contents stream in after
        # the meshes
        arena, texture_jobs = build_streaming_arena(
            world.doc, max_dim=args.max_texture_dim, scene_path=scene_path)
    else:
        arena = build_texture_arena(world.doc, max_dim=args.max_texture_dim,
                                    scene_path=scene_path)
    log_info("Scene ready in %.2fs", timer.get_seconds())
    if args.scatter_lights > 0:
        _scatter_lights(world, args.scatter_lights)
        log_info("scattered %d point lights", world.lights.point_count)

    static_np = world.static_scene_arrays()
    static = static_tensors(static_np, dev)
    arena_t = arena_tensors(arena.uniforms(), static_np["materials"], dev)
    lut_np, lut_name = _display_lut()
    lut = torch.as_tensor(lut_np, device=dev)
    log_info("display LUT: %s", lut_name)
    geom_cache = GeometryCache()
    # camera jitter rides with TAA, as the reference's (Renderer.cpp:329-340)
    cam_obj = world.make_camera((args.width, args.height),
                                apply_jitter=args.taa)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".",
                exist_ok=True)

    env = ibl_data = None
    if args.ibl and args.mode in _MODE_FLAGS["ibl"]:
        from ..ops.ibl import build_ibl, procedural_sky

        env = procedural_sky(args.env_res, device=dev)
        if args.mode == "deferred":  # the path tracer reads env alone
            ibl_data = build_ibl(env)
            ibl_data["env"] = env
        log_info("IBL generated")

    if group is None:
        render_fn = render_modes()[args.mode]
    else:
        from ..render.distributed import sharded_render_modes

        render_fn = sharded_render_modes(group)[args.mode]
    main_rank = group is None or torch.distributed.get_rank(group) == 0
    opts = _mode_options(args, world, env, ibl_data)
    base_eye = np.array(cam_obj.transform.eye, np.float32)
    base_target = np.array(cam_obj.transform.target, np.float32)
    focus_readback = TextureReadback()
    state = img = None
    scene = cam = None

    def run(frame_index, state):
        return render_fn(scene=scene, cam=cam, lut=lut, width=args.width,
                         height=args.height, device=dev,
                         exposure=args.exposure, contrast=args.contrast,
                         frame_index=frame_index, state=state, **opts)

    # two frames in flight (Utils.hpp:15 MAX_FRAMES_IN_FLIGHT): frame f+1's
    # host work (animation, frame_arrays, the BVH build, uploads) overlaps
    # frame f on the card; the loop waits only when the pipeline is full
    inflight = deque()
    starts = []

    def drain(limit):
        while len(inflight) >= limit:
            f0, done, t00 = inflight.popleft()
            if done is not None:
                with gprofiler.wait("cli.frames_in_flight"):
                    done.synchronize()
            log_info("frame %d: %.1f ms", f0,
                     (time.perf_counter() - t00) * 1e3)

    # --profile: the host spans of every frame (utils/profiler.py)
    with gprofiler.recording(args.profile):
        for f in range(args.frames):
            gprofiler.start_frame(f)
            starts.append(time.perf_counter())
            if args.orbit_camera and f > 0:
                _orbit(cam_obj, base_eye, base_target, f, args.frames)
            if args.streaming:
                with gprofiler.host("streaming"):
                    if f == 0:
                        world.start_streaming(texture_jobs)
                    was_done = world.streaming_done
                    if world.poll_streaming():
                        # textures: in-place writes over their neutral
                        # rows, queued after the frames in flight
                        for tex in world.take_adopted_textures():
                            arena_write(arena_t["data"], tex.chunk,
                                        tex.offset)
                        if world.streaming_dirty:
                            # meshes: fresh static tensors, fresh geometry
                            static = static_tensors(
                                world.static_scene_arrays(), dev)
                            world.streaming_dirty = False
                            geom_cache = GeometryCache()
                    if world.streaming_done and not was_done:
                        log_info("streaming finished before frame %d", f)
            if args.autofocus:
                # the depth pick queued a frame ago (App.cpp:607-631)
                d = focus_readback.poll()
                if d is not None:
                    cam_obj.parameters.focus_distance = focus_from_depth(
                        float(d), cam_obj.uniforms())
            t_anim = args.time + (f / 60.0 if args.animate else 0.0)
            with gprofiler.host("frame_arrays"):
                frame = world.frame_arrays(t_anim)
            with gprofiler.host("upload"):
                scene = {"static": static,
                         "frame": frame_tensors(frame, dev),
                         "arena": arena_t,
                         "geom": geom_cache.get(static, frame["transforms"],
                                                frame["normal_transforms"])}
                cam = camera_tensors(cam_obj.uniforms(), dev)
            t0 = time.perf_counter()
            with gprofiler.host("render"):
                img, state = run(f, state)
            done = None
            if dev.type == "cuda":
                done = torch.cuda.Event()
                done.record()
            inflight.append((f, done, t0))
            if args.autofocus and isinstance(state, dict) \
                    and state.get("depth") is not None:
                focus_readback.queue(state["depth"], (0.5, 0.5))
            drain(2)
            cam_obj.end_frame()
            frame_spans = gprofiler.end_frame()
            if args.profile and main_rank:
                print(frame_spans.report().table())
            if args.fps_limit > 0:
                # the frame cap (App.cpp capFramerate analog)
                time.sleep(max(0.0, 1.0 / args.fps_limit
                               - (time.perf_counter() - starts[-1])))
    drain(1)
    t_end = time.perf_counter()
    steady = (f"; frames 1-{args.frames - 1}: "
              f"{(t_end - starts[1]) * 1e3 / (args.frames - 1):.3f} ms/frame"
              if args.frames > 1 else "")
    log_info("%d frames on %s: %.3f ms/frame wall%s", args.frames, dev,
             (t_end - starts[0]) * 1e3 / args.frames, steady)

    last_f = args.frames - 1
    # every rank runs the profiled frame (its collectives); rank 0 prints
    say = print if main_rank else (lambda *a: None)
    if args.profile:
        # the per-pass device table (Profiler.hpp:19-327's per-pass GPU
        # queries) and the launches of the last frame, run again under
        # torch.profiler
        from ..utils.dispatch_count import count_dispatches
        from ..utils.profiler import idle_by_span, pass_table

        counted = {}
        gprofiler.clear()
        with count_dispatches(counted, dev):
            run(last_f, state)
        rows = pass_table(counted["events"], 1, dev)
        what = "device ms" if dev.type == "cuda" else "cpu ms"
        say(f"{'pass':<28}{what:>12}")
        for name, ms in rows:
            say(f"{name:<28}{ms:>12.3f}")
        say(f"{'frame total':<28}{sum(ms for _, ms in rows):>12.3f}")
        what = "kernel launches" if dev.type == "cuda" else "ATen calls"
        say(f"{what} per frame: {counted['n']}")
        by_short = Counter()
        for name, n in counted["by_name"].items():
            by_short[_short(name)] += n
        say("by name: " + "; ".join(
            f"{name} {n}" for name, n in by_short.most_common()))
        if dev.type == "cuda":
            # the card's idle gaps in that frame, named by the innermost
            # span open on the host at each gap's middle
            say(f"{'device idle under span':<28}{'gaps':>8}{'ms':>12}")
            for name, n, ms in idle_by_span(counted["events"],
                                            counted["trace_start_ns"],
                                            gprofiler.frames()):
                say(f"{name:<28}{n:>8}{ms:>12.3f}")

    if args.profile_device:
        from ..utils.profiler import profile_device_ops

        ops = profile_device_ops(lambda: run(last_f, state)[0], runs=1,
                                 device=dev)
        say(f"{'device op':<70}{'ms':>10}")
        for name, ms in ops:
            say(f"{name[:70]:<70}{ms:>10.3f}")

    if not main_rank:
        return 0
    host_img = img.cpu().numpy()
    write_png(args.out, host_img)
    log_info("wrote %s", args.out)
    if args.dump_debug:
        from ..render.debug import dump_texture

        dump_texture(host_img, args.dump_debug)
        log_info("dumped %s(.npy)", args.dump_debug)
    return 0


if __name__ == "__main__":
    sys.exit(main())
