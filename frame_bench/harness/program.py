"""The system under test: prosper_tpu_torch's frame call on the
benchmark's inputs.

`build_scene` hands the raw inputs to the port's scene path (the BVH
build, the light rows, the upload and the trace slabs); `frame_call`
takes the frame call `fn(scene, cam, frame_index, state)` from
`prosper_tpu_torch.entry.entry`, which is then driven on that scene.
`TraceCalls` records what each call of a trace kernel's wrapper was
handed, for the bytes bound of the trace kernels.
"""

from __future__ import annotations

import numpy as np


def build_scene(inputs: dict, bvh: bool, device) -> dict:
    """The port's scene tensors from a generator's inputs, in either of
    its two forms.

    The glTF form ("gltf": a file's path): the port's glTF path, as
    entry(scene=path) takes it (entry.gltf_scene: World, its texture
    arena, its frame arrays), with no cache read or written, then
    scene/convert.from_numpy_scene; the BVH arrays dropped without bvh.

    The plate form (the arrays p0, p1, p2, aidx, a_packed, ...): cluster
    boxes and the BVH2 (accel/bvh.py), the packed light rows
    (scene/lights.py), then from_numpy_scene (upload, slabs, material
    tables), laid out as testing.make_plate_scene lays them out: cluster
    c's 128 triangles at rows [128 c, 128 c + 128), one identity
    instance, the 1-texel white texture arena."""
    from prosper_tpu_torch.scene.convert import from_numpy_scene

    if "gltf" in inputs:
        from prosper_tpu_torch.entry import gltf_scene

        static, frame, arena, _ = gltf_scene(inputs["gltf"], use_cache=False)
        if not bvh:
            frame = {k: v for k, v in frame.items()
                     if k not in ("bvh_bounds", "bvh_meta", "bvh_nodes8")}
        return from_numpy_scene(static, frame, arena, device)

    from prosper_tpu_torch.accel.bvh import build_bvh, pack_nodes
    from prosper_tpu_torch.scene.lights import LightArrays, light_uniforms

    p0, p1, p2 = inputs["p0"], inputs["p1"], inputs["p2"]
    C = p0.shape[0] // 128
    corners = np.stack([p0, p1, p2], 1).reshape(C, 128 * 3, 3)
    wc_min, wc_max = corners.min(1), corners.max(1)
    center = (wc_min + wc_max) / 2
    nv = inputs["a_packed"].shape[0] // C
    static = {
        "wc_instance": np.zeros(C, np.int32),
        "wc_material": inputs["cluster_material"],
        "wc_sphere_center": center.astype(np.float32),
        "wc_sphere_radius": np.linalg.norm(wc_max - center, axis=1).astype(np.float32),
        "wc_cone_axis": inputs["a_packed"][::nv, 0:3].copy(),
        "wc_cone_cutoff": np.ones(C, np.float32),
        "wc_tri_count": np.full(C, 128, np.int32),
        "wt_p0": p0, "wt_p1": p1, "wt_p2": p2,
        "wt_aidx": inputs["aidx"],
        "wt_instance": np.zeros(p0.shape[0], np.int32),
        "wt_material": inputs["tri_material"],
        "a_packed": inputs["a_packed"],
        "materials": inputs["materials"],
    }
    lights = LightArrays()
    lights.dir_irradiance = inputs["sun_irradiance"]
    lights.dir_direction = inputs["sun_direction"]
    n = inputs["point_position"].shape[0]
    lights.point_position[:n] = inputs["point_position"]
    lights.point_radiance[:n] = inputs["point_radiance"]
    lights.point_radius[:n] = inputs["point_radius"]
    lights.point_count = n
    frame = {
        "wc_aabb_min_w": wc_min,
        "wc_aabb_max_w": wc_max,
        "transforms": np.eye(4, dtype=np.float32)[None, :3, :4],
        "normal_transforms": np.eye(3, dtype=np.float32)[None],
        "lights": light_uniforms(lights),
    }
    if bvh:
        frame["bvh_bounds"], frame["bvh_meta"] = pack_nodes(
            build_bvh(wc_min, wc_max, max_leaf_size=1))
    arena = {
        "data": np.full((1, 4), 0xFFFFFFFF, np.uint32),
        "table": np.zeros((1, 13, 4), np.int32)
        + np.array([0, 1, 1, 0], np.int32)[None, None, :],
        "n_mips": np.ones(1, np.int32),
    }
    return from_numpy_scene(static, frame, arena, device)


def clusters(scene: dict) -> dict:
    """The program's partition of the scene into clusters, on the host:
    each cluster's triangles (wt_aidx rows, vertex rows of its attribute
    arena; the first wc_tri_count of its 128 slots) and instance."""
    st = scene["static"]
    return {k: st[k].detach().cpu().numpy()
            for k in ("wt_aidx", "wc_tri_count", "wc_instance")}


def camera(uniforms: dict, device) -> dict:
    from prosper_tpu_torch.scene.convert import camera_tensors

    return camera_tensors(uniforms, device)


def frame_call(options: dict, width: int, height: int, device):
    """fn(scene, cam, frame_index, state) -> (image, state, count) of
    entry(); its own scene (the smallest plate scene) is not used."""
    from prosper_tpu_torch.entry import entry

    fn, _ = entry(device=device, scene="plate", n_clusters=1, width=width,
                  height=height, **options)
    return fn


def set_policy(policy: dict) -> None:
    """Set config.policy fields (read by the port at every frame)."""
    from prosper_tpu_torch import config

    for k, v in policy.items():
        setattr(config.policy, k, v)


class TraceCalls:
    """Patches every trace wrapper named in `table` ({wrapper: {"module",
    "kernel", "rays", "ray_arg", "result_bytes"}}) wherever the port's
    modules hold it, and records for each call the kernel symbol and the
    bytes its inputs and results need: each ray's inputs read once, each
    ray's results (`result_bytes`: the fields the call returns as
    results, not the padding of its rows) written once, and the
    positions of the triangles it may test (36 B a triangle: the whole
    scene, or the clusters a `skip_mask` keeps) read once."""

    def __init__(self, table: dict):
        self.table = table
        # (kernel, rays, ray bytes, skip mask or None, scene triangle bytes)
        self._calls: list = []
        self._undo = []

    @property
    def calls(self) -> list[tuple[str, int, int]]:
        """(kernel, rays, bytes) of each call; a skip mask is counted
        here, after the window, so that no call waits for the device."""
        out = []
        for kernel, rays, n_bytes, mask, tri_bytes in self._calls:
            if mask is not None:
                tri_bytes = tri_bytes * int(mask.sum()) // mask.numel()
            out.append((kernel, rays, n_bytes + tri_bytes))
        return out

    def _wrap(self, name, real, spec):
        calls = self._calls

        def rec(slabs, *args, **kw):
            out = real(slabs, *args, **kw)
            ray_arg = args[spec["ray_arg"]]
            if spec["rays"] == "pixels":  # (T, 3, 256) pixel columns
                rays = ray_arg.shape[0] * ray_arg.shape[2]
                n_bytes = ray_arg.numel() * ray_arg.element_size()
            else:  # origins, directions, t_max
                rays = ray_arg.shape[0]
                n_bytes = rays * (3 + 3 + 1) * 4
            n_bytes += rays * int(spec["result_bytes"])
            calls.append((spec["kernel"], rays, n_bytes, kw.get("skip_mask"),
                          36 * slabs.shape[0] * slabs.shape[2]))
            return out

        # the wrappers count their launches on the module-level name
        # (`trace_any_bvh.launches += 1`), which now names rec
        rec.launches = getattr(real, "launches", 0)
        return rec

    def __enter__(self):
        import importlib
        import sys

        reals = {}
        for name, spec in self.table.items():
            mod = importlib.import_module(spec["module"])
            reals[name] = (getattr(mod, name), spec)
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or not (mod_name == "prosper_tpu_torch"
                                   or mod_name.startswith("prosper_tpu_torch.")):
                continue
            for name, (real, spec) in reals.items():
                if getattr(mod, name, None) is real:
                    self._undo.append((mod, name, real))
                    setattr(mod, name, self._wrap(name, real, spec))
        return self

    def __exit__(self, *exc):
        for mod, name, real in reversed(self._undo):
            setattr(mod, name, real)
        self._undo = []
        return False
