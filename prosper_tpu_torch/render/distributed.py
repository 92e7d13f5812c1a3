"""Multi-rank rendering: a frame split into horizontal pixel bands over
torch.distributed ranks.

Counterpart of prosper_tpu/render/distributed.py (`make_mesh` :30,
`pt_render_sharded` :35, `restir_render_sharded` :96,
`deferred_render_sharded` :207, `sharded_render_modes` :293), in
PyTorch's idiom: SPMD ranks, one process each, each rendering its own
band through an explicit process group on an explicit device, where the
JAX package runs one program over a device mesh (shard_map). Every rank
calls the same function with the same arguments; each returns the
gathered frame.

- `init_ranks` (for `make_mesh`) joins a process group through a
  FileStore in a directory the ranks share (no TCP port, so parallel
  runs cannot collide), with a timeout, so that a rank that hangs fails
  the run. The backend is the caller's choice: "nccl" where every rank
  has a card of its own, "gloo" on the CPU and for several ranks that
  share one card; gloo's collectives take CPU tensors, so with card
  tensors the exchanges are staged through host memory explicitly.
- `run_ranks` starts the ranks (torch.multiprocessing, spawn) with the
  backend and the device of each rank that the caller names, each
  running a worker function after `init_ranks`, and returns what each
  worker returned. The workers of the tests (`frame_worker`) and of the
  CLI live in this package, so the ranks import neither JAX nor a test
  module.
- `replicate_to_mesh` has no counterpart: every rank holds its own copy
  of the scene (the CLI's ranks each load the scene file).

Bands (rows are absolute frame coordinates, so every pixel's RNG stream,
froxel and neighbour rows are the single-rank frame's):

- PT: rank d traces the row-major pixels [d R / n, (d + 1) R / n) of the
  R = W H pixels (R % n == 0) through pt_trace_pixels; the ray counts
  are summed (all_reduce, JAX's psum).
- ReSTIR: bands of ceil(H / n) rows. The spatial reuse of a band reads
  the 3 SPATIAL_RADIUS rows above it and the SPATIAL_RADIUS rows below
  it (spatial_reuse.comp's offsets lie in [-3R, R]): each rank
  all_gathers its top and bottom rows, then assembles its own halo,
  taking rows from several ranks away when a band is shorter than the
  halo and zeros past the frame's edges, the rows JAX's ppermute hops
  deliver (:175-192).
- Deferred: bands of ceil(H / 32n) * 32 rows, so a band starts on a
  froxel tile row and shades the single-rank frame's light lists.

Rows past the frame (the last bands' padding) are traced and shaded,
then cropped after the gather; the ReSTIR edge test rejects them as
neighbours, and they do not count as shadow rays. The post chain (TAA,
bloom, DoF, particles), the transparent pass and culling are not
sharded; accumulation and the tone map run on the gathered frame on
every rank.

Unlike the JAX package's band G-buffer, whose ray cones follow the
band's height (prosper_tpu/render/gbuffer.py:372), the port's follow
the full frame's, so a sharded frame equals the single-rank frame on
textured scenes too (render/gbuffer.py). Where the JAX sharded modes
drop alpha_rounds and aniso_taps, the port passes them to the band
G-buffer.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

from ..ops.shade_tiles import TILE_PX, build_tile_light_lists
from ..ops.tonemap import tone_map
from ..ops.trace_bvh import check_stack_overflow, pack_pixels_np
from ..scene.convert import camera_tensors, check_device
from .deferred import shade_deferred, skybox
from .gbuffer import render_gbuffer
from .pt import pt_accumulate, pt_trace_pixels
from .restir import (
    SPATIAL_RADIUS,
    initial_neighbor_rows,
    restir_shade,
    shadow_tracer,
    spatial_reuse,
)
from .shading import has_local_lights

SHARDED_MODES = ("pt", "restir", "deferred")
TIMEOUT_S = 120  # a rank that waits longer at a collective fails the run
HALO_UP = int(3 * SPATIAL_RADIUS)  # neighbour rows above a band
HALO_DN = int(SPATIAL_RADIUS)  # and below it


def init_ranks(backend: str, rank: int, world_size: int, store_dir: str):
    """Join the process group of world_size ranks as `rank` over backend
    ("gloo" or "nccl"), through a FileStore at store_dir/store that
    every rank names -> the group."""
    store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dist.group.WORLD


def _rank_main(rank, world_size, backend, devices, store_dir, threads,
               worker, args):
    if threads:
        torch.set_num_threads(threads)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    group = init_ranks(backend, rank, world_size, store_dir)
    try:
        out = worker(rank, group, device, *args)
        torch.save(out, os.path.join(store_dir, f"out{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(worker, world_size: int, *args, backend: str, devices,
              threads: int | None = 1) -> list:
    """Run worker(rank, group, device, *args) in world_size spawned
    processes -> the list of their return values (saved with torch.save,
    so tensors come back on their device: return host data).

    backend: "gloo" or "nccl" (init_ranks); devices: one device name a
    rank, e.g. ["cuda:0", "cuda:1"] or ["cpu"] * world_size; threads:
    torch's intra-op threads a rank (None: torch's default). worker must
    be importable by name (a module-level function) in a fresh
    interpreter. A rank that raises makes this raise (the exception
    names the rank and its traceback) and ends the other ranks; a rank
    that waits at a collective fails after init_ranks' TIMEOUT_S."""
    import torch.multiprocessing as mp

    devices = list(devices)
    if len(devices) != world_size:
        raise ValueError(f"{len(devices)} devices for {world_size} ranks")
    with tempfile.TemporaryDirectory(prefix="prosper_ranks_") as store_dir:
        mp.start_processes(
            _rank_main, nprocs=world_size, start_method="spawn", join=True,
            args=(world_size, backend, devices, store_dir, threads, worker,
                  args))
        return [torch.load(os.path.join(store_dir, f"out{r}.pt"),
                           weights_only=False) for r in range(world_size)]


def band_rows(mode: str, height: int, n: int) -> int:
    """Rows of each rank's band of a height-row frame over n ranks:
    ceil(H / n) for "restir", ceil(H / 32n) * 32 for "deferred" (a band
    starts on a froxel tile row). The last bands may run past the frame.
    PT splits pixels, not rows (pt_render_sharded)."""
    if mode == "restir":
        return -(-height // n)
    if mode == "deferred":
        return -(-height // (n * TILE_PX)) * TILE_PX
    raise ValueError(f"mode {mode!r} has no row bands")


def halo_slab_rows(band_h: int) -> tuple[int, int]:
    """(bottom, top) rows of a band of band_h rows that each rank sends
    for halo_rows: min(band_h, HALO_UP), min(band_h, HALO_DN)."""
    return min(band_h, HALO_UP), min(band_h, HALO_DN)


# ---------------------------------------------------------------------------
# Exchanges


def _staged(group, t: torch.Tensor) -> bool:
    """Whether t goes through host memory: gloo with a card tensor."""
    return dist.get_backend(group) == "gloo" and t.device.type == "cuda"


def all_gather_cat(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' equal-shaped t, concatenated in rank order along dim 0,
    on t's device."""
    src = t.contiguous()
    if _staged(group, t):
        src = src.cpu()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(t.device)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of t over the ranks, on t's device."""
    out = t.cpu() if _staged(group, t) else t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(t.device)


def halo_rows(rows: torch.Tensor, group) -> torch.Tensor:
    """A band's (band_h, C) rows -> (HALO_UP + band_h + HALO_DN, C): the
    HALO_UP rows of the frame above the band, the band, the HALO_DN rows
    below it, from the bands of equal height on the other ranks (zeros
    past the first and the last band). One all_gather of each rank's
    bottom min(band_h, HALO_UP) and top min(band_h, HALO_DN) rows."""
    up, dn = HALO_UP, HALO_DN
    band_h, n_ch = rows.shape
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    nb, nt = halo_slab_rows(band_h)
    slabs = all_gather_cat(torch.cat([rows[band_h - nb:], rows[:nt]]),
                           group).reshape(n, nb + nt, n_ch)
    y0 = rank * band_h

    def zeros(k):
        return rows.new_zeros((k, n_ch))

    above = [zeros(max(0, up - y0))]
    for s in range(rank):  # bands above: their bottom rows
        lo, hi = max(y0 - up, s * band_h), min(y0, (s + 1) * band_h)
        if lo < hi:
            first = lo - s * band_h - (band_h - nb)
            above.append(slabs[s, first:first + hi - lo])
    below = []
    for s in range(rank + 1, n):  # bands below: their top rows
        lo = max(y0 + band_h, s * band_h)
        hi = min(y0 + band_h + dn, (s + 1) * band_h)
        if lo < hi:
            first = nb + lo - s * band_h
            below.append(slabs[s, first:first + hi - lo])
    end = y0 + band_h + dn
    below.append(zeros(max(0, end - max(n * band_h, y0 + band_h))))
    return torch.cat(above + [rows] + below)


# ---------------------------------------------------------------------------
# Sharded frames


@lru_cache(maxsize=8)
def _pt_band(width: int, height: int, n: int, rank: int, device: str):
    """(px, py, cols) of rank's contiguous row-major pixels."""
    per = width * height // n
    idx = np.arange(rank * per, (rank + 1) * per)
    px, py = idx % width, idx // width
    return (torch.as_tensor(px, device=device),
            torch.as_tensor(py, device=device),
            torch.as_tensor(pack_pixels_np(px, py)[0], device=device))


def pt_render_sharded(group, scene: dict, cam: dict, width: int,
                      height: int, frame_index: int, max_bounces: int = 3,
                      use_dof: bool = False, env=None, alpha_rounds: int = 0,
                      clamp_indirect: bool = False, *, device):
    """One 1-spp PT sample with the pixels split over the group's ranks
    -> ((H*W, 3) colour in row-major order, the total ray count, int64),
    on every rank. env, use_dof, alpha_rounds, clamp_indirect: as
    render/pt.pt_trace_pixels."""
    dev = check_device(scene, device)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    if (width * height) % n:
        raise ValueError(f"{width}x{height} pixels do not split over {n} "
                         "ranks")
    px, py, cols = _pt_band(width, height, n, rank, str(dev))
    if env is not None:
        env = torch.as_tensor(env, dtype=torch.float32, device=dev)
    color, n_rays = pt_trace_pixels(
        scene, camera_tensors(cam, dev), px, py, cols, width, height,
        frame_index, max_bounces, clamp_indirect, use_dof, env, alpha_rounds)
    return all_gather_cat(color, group), all_reduce_sum(n_rays, group)


def restir_render_sharded(group, scene: dict, cam: dict, width: int,
                          height: int, frame_index: int,
                          alpha_rounds: int = 0, *, device):
    """A ReSTIR DI frame in bands of ceil(H / n) rows -> ((H*W, 3) linear
    colour in row-major order, the number of shadow rays of the frame,
    int64), on every rank: the band G-buffer, initial reservoirs,
    spatial reuse over the band and its halo (halo_rows), traced
    shading through the band's shadow tracer."""
    dev = check_device(scene, device)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    cam = camera_tensors(cam, dev)
    band_h = band_rows("restir", height, n)
    y0 = rank * band_h
    gbuf = render_gbuffer(scene, cam, width, band_h,
                          alpha_rounds=alpha_rounds, y_offset=y0,
                          full_height=height)
    surface = dict(gbuf["surface"])
    c2c = cam["camera_to_clip"]
    surface["linear_depth"] = -c2c[2, 3] / (gbuf["depth"] + c2c[2, 2])
    px = torch.arange(width, device=dev).repeat(band_h)
    py = torch.arange(y0, y0 + band_h, device=dev).repeat_interleave(width)
    lights = scene["frame"]["lights"]
    rows = initial_neighbor_rows(surface, lights, gbuf["normal_metallic"],
                                 gbuf["valid"], px, py, frame_index)
    neigh = halo_rows(rows.reshape(band_h, width * 8), group)
    li1, ucw1 = spatial_reuse(
        surface, lights, neigh.reshape(-1, 8), px, py, width, height,
        frame_index, neigh_y0=y0 - HALO_UP,
        neigh_rows_h=band_h + HALO_UP + HALO_DN)
    color, traced = restir_shade(surface, lights, li1, ucw1,
                                 shadow_tracer(scene, width, band_h))
    check_stack_overflow(dev)
    inside = max(0, min(band_h, height - y0)) * width
    n_shadow = all_reduce_sum(traced[:inside].sum(), group)
    return all_gather_cat(color, group)[:height * width], n_shadow


def deferred_render_sharded(group, scene: dict, cam: dict, width: int,
                            height: int, ibl_data: dict | None = None,
                            alpha_rounds: int = 0, aniso_taps: int = 1, *,
                            device):
    """The core deferred frame (G-buffer, clustered shading with IBL when
    ibl_data is given, the skybox where it holds "env") in bands of
    ceil(H / 32n) * 32 rows -> (H*W, 3) linear colour in row-major order,
    on every rank."""
    dev = check_device(scene, device)
    n, rank = dist.get_world_size(group), dist.get_rank(group)
    cam = camera_tensors(cam, dev)
    band_h = band_rows("deferred", height, n)
    y0 = rank * band_h
    band = {"y_offset": y0, "full_height": height}
    gbuf = render_gbuffer(scene, cam, width, band_h,
                          alpha_rounds=alpha_rounds, aniso_taps=aniso_taps,
                          **band)
    lights = scene["frame"]["lights"]
    lists = (build_tile_light_lists(cam, lights, width, band_h, **band)
             if has_local_lights(lights) else None)
    color = shade_deferred(gbuf, lights, cam, width, band_h, ibl_data, lists,
                           **band)
    if ibl_data is not None and "env" in ibl_data:
        color = torch.where(gbuf["valid"][:, None], color,
                            skybox(ibl_data["env"], cam, width, band_h,
                                   **band))
    return all_gather_cat(color, group)[:height * width]


def sharded_render_modes(group) -> dict:
    """The `--devices N` mode table: "pt", "restir" and "deferred" with
    render/frame.render_modes' protocol, f(*, scene, cam, lut, width,
    height, device, exposure, contrast, frame_index, state, **options)
    -> (image (H, W, 3), state), each call rendering its frame over the
    group's ranks (every rank calls it). PT and ReSTIR accumulate into
    (running mean, sample count), as pt_entry and restir_entry do;
    deferred passes its state through. Options the sharded frames do not
    take (the post chain, culling, the transparent pass) are ignored:
    the CLI drops them with a log line."""

    def display(color, lut, exposure, contrast, dev):
        lut = torch.as_tensor(lut, dtype=torch.float32, device=dev)
        return tone_map(color, lut, exposure, contrast)

    def accumulate(sample, state):
        if state is None:
            return sample, torch.ones(sample.shape[:2], dtype=torch.float32,
                                      device=sample.device)
        return pt_accumulate(state[0], state[1], sample)

    def pt_mode(*, scene, cam, lut, width, height, device, exposure=1.0,
                contrast=1.0, max_bounces=3, frame_index=0, state=None,
                env=None, alpha_rounds=0, **_):
        color, _ = pt_render_sharded(
            group, scene, cam, width, height, frame_index, max_bounces,
            env=env, alpha_rounds=alpha_rounds, device=device)
        acc, count = accumulate(color.reshape(height, width, 3), state)
        return display(acc, lut, exposure, contrast, acc.device), (acc, count)

    def restir_mode(*, scene, cam, lut, width, height, device, exposure=1.0,
                    contrast=1.0, frame_index=0, state=None, alpha_rounds=0,
                    **_):
        color, _ = restir_render_sharded(
            group, scene, cam, width, height, frame_index, alpha_rounds,
            device=device)
        acc, count = accumulate(color.reshape(height, width, 3), state)
        return display(acc, lut, exposure, contrast, acc.device), (acc, count)

    def deferred_mode(*, scene, cam, lut, width, height, device, exposure=1.0,
                      contrast=1.0, state=None, ibl_data=None,
                      alpha_rounds=0, aniso_taps=1, **_):
        color = deferred_render_sharded(
            group, scene, cam, width, height, ibl_data, alpha_rounds,
            aniso_taps, device=device).reshape(height, width, 3)
        return display(color, lut, exposure, contrast, color.device), state

    return {"pt": pt_mode, "restir": restir_mode, "deferred": deferred_mode}


def frame_worker(rank, group, device, job: dict) -> list:
    """A rank of run_ranks rendering sharded frames of a procedural or
    glTF scene: job = {"scene": (make_scene, args, kwargs) -> (static,
    frame, arena, cam_fn) numpy dicts (testing.make_test_scene's
    layout; e.g. entry.gltf_scene), "width", "height", "calls": [(mode,
    options), ...]} with mode "pt" (frame_index, max_bounces, ...),
    "restir" (frame_index, ...) or "deferred" (...), the options of
    that mode's *_render_sharded. Returns, per call, (colour (H*W, 3)
    float32 numpy, ray count or None) on every rank."""
    from ..scene.convert import from_numpy_scene

    make_scene, args, kwargs = job["scene"]
    static, frame, arena, cam_fn = make_scene(*args, **kwargs)
    width, height = job["width"], job["height"]
    scene = from_numpy_scene(static, frame, arena, device)
    cam = camera_tensors(cam_fn(width, height), device)
    fns = {"pt": pt_render_sharded, "restir": restir_render_sharded,
           "deferred": deferred_render_sharded}
    out = []
    for mode, options in job["calls"]:
        got = fns[mode](group, scene, cam, width, height, **options,
                        device=device)
        color, stat = got if isinstance(got, tuple) else (got, None)
        out.append((color.cpu().numpy(),
                    None if stat is None else int(stat)))
    return out
