"""World: a glTF scene -> flat scene arrays and per-frame updates.

A copy of prosper_tpu/scene/world.py (numpy) over the port's own scene
modules. The reference's World/WorldData own the scene data and drive
per-frame updates (updateAnimations -> updateScene -> updateBuffers ->
buildAccelerationStructures; World.cpp:349-575 of the reference):

- Geometry is flattened per DrawInstance into padded 128-triangle
  cluster slots of one arena, a tile a meshlet of at most 124 triangles
  and 64 distinct vertices (scene/meshlets.py; so a tile is not always
  full, and meshlet_counters says how full); positions stay in object
  space and the trace slabs put them in world space each frame
  (ops/slabs.py), the "TLAS rebuilt every frame" of World.cpp:749-802.
- A cluster BVH is rebuilt per frame on the host from conservatively
  transformed cluster AABBs, packed as the BVH2 node arrays and as the
  8-wide table (accel/bvh.py).
- Every processed primitive is quantized as the reference packs it
  (positions f16, normals and tangents 10-10-10-2 snorm, uv f16),
  whatever the cache state, so rendering does not depend on the cache.
- Materials, lights and the camera are SoA dicts.
- A primitive's meshlets are made in a host span "world.meshlets"
  (utils/profiler.py), recorded where a frame is recorded on the
  thread that opened it.
- World(streaming=True) lays the arenas out from each primitive's
  partition into meshlets (made at construction, and handed to its
  adoption) with placeholder meshes (tri_count 0, degenerate triangles:
  invisible to rays and to the culler), so an adopted mesh fills exactly
  the clusters its placeholder reserved; start_streaming launches
  scene/streaming.py's worker, and poll_streaming adopts finished meshes
  into the host arrays between frames, after which the caller uploads
  static_scene_arrays() again (streaming_dirty).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..accel.bvh import (
    Bvh,
    build_bvh,
    nodes8_depth,
    pack_nodes,
    pack_nodes8,
    transform_aabbs,
)
from ..utils.profiler import gprofiler
from . import animation as anim
from .camera import Camera, CameraParameters, CameraTransform
from .gltf import GltfDocument, load_gltf
from .lights import LightArrays, light_uniforms, load_lights
from .meshlets import (
    CLUSTER_TRI_PAD,
    MeshClusters,
    build_clusters,
    cluster_ranges,
    cluster_vertex_counts,
)
from .scene_graph import SceneGraph, build_scene_graph, update_scene

_log = logging.getLogger(__name__)


@dataclass
class MeshData:
    """Per flat mesh (glTF primitive): cluster table + vertex attributes."""

    clusters: MeshClusters
    positions: np.ndarray  # (V, 3) f32 object space
    normals: np.ndarray  # (V, 3) f32
    tangents: np.ndarray  # (V, 4) f32 xyz + sign
    uv0: np.ndarray  # (V, 2) f32
    material: int  # flat material index (0 = default)
    vertex_count: int = 0
    cluster_vertices: np.ndarray | None = None  # (C,) distinct vertices

    def __post_init__(self) -> None:
        self.vertex_count = len(self.positions)
        cl = self.clusters
        self.cluster_vertices = cluster_vertex_counts(
            cl.tri_vidx, cl.cluster_offset, cl.cluster_count)


def _default_tangents(normals: np.ndarray) -> np.ndarray:
    """Deterministic tangent frame for meshes without TANGENT or uv-based
    tangents."""
    n = normals
    ref = np.where(
        (np.abs(n[:, 1:2]) < 0.99), np.array([[0.0, 1.0, 0.0]]), np.array([[1.0, 0.0, 0.0]])
    )
    t = np.cross(ref, n)
    t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-20)
    return np.concatenate([t, np.ones((len(n), 1))], axis=1).astype(np.float32)


@dataclass
class MaterialTable:
    """SoA MaterialData (shader_structs/scene/material_data.h:52-66).

    Index 0 is the default material like WorldData::loadMaterials
    (WorldData.cpp:760 pushes a default first).
    Texture indices are into the world texture array; 0 = neutral default
    (1px white / flat normal), matching the reference's default texture
    at index 0 (WorldData.cpp:726-755).
    """

    base_color_factor: np.ndarray
    metallic_factor: np.ndarray
    roughness_factor: np.ndarray
    alpha_cutoff: np.ndarray
    alpha_mode: np.ndarray  # 0 opaque / 1 mask / 2 blend
    base_color_tex: np.ndarray  # i32, 0 = none/default
    metallic_roughness_tex: np.ndarray
    normal_tex: np.ndarray

    def uniforms(self) -> dict[str, np.ndarray]:
        return {
            "base_color_factor": self.base_color_factor,
            "metallic_factor": self.metallic_factor,
            "roughness_factor": self.roughness_factor,
            "alpha_cutoff": self.alpha_cutoff,
            "alpha_mode": self.alpha_mode,
            "base_color_tex": self.base_color_tex,
            "metallic_roughness_tex": self.metallic_roughness_tex,
            "normal_tex": self.normal_tex,
        }


def _build_materials(doc: GltfDocument) -> MaterialTable:
    n = len(doc.materials) + 1
    # material ids ride the f16 trace-slab arena (trace_pallas_full
    # TRIS_DTYPE) where integers are exact only up to 2048; the
    # reference caps materials well below this too
    assert n <= 2048, f"{n} materials exceed the f16 arena id range"
    mt = MaterialTable(
        base_color_factor=np.ones((n, 4), np.float32),
        metallic_factor=np.ones(n, np.float32),
        roughness_factor=np.ones(n, np.float32),
        alpha_cutoff=np.full(n, 0.5, np.float32),
        alpha_mode=np.zeros(n, np.int32),
        base_color_tex=np.zeros(n, np.int32),
        metallic_roughness_tex=np.zeros(n, np.int32),
        normal_tex=np.zeros(n, np.int32),
    )
    for i, m in enumerate(doc.materials):
        j = i + 1
        mt.base_color_factor[j] = m.base_color_factor
        mt.metallic_factor[j] = m.metallic_factor
        mt.roughness_factor[j] = m.roughness_factor
        mt.alpha_cutoff[j] = m.alpha_cutoff
        mt.alpha_mode[j] = m.alpha_mode
        # +1: world texture array slot 0 is the neutral default
        mt.base_color_tex[j] = m.base_color_texture.image + 1
        mt.metallic_roughness_tex[j] = m.metallic_roughness_texture.image + 1
        mt.normal_tex[j] = m.normal_texture.image + 1
    return mt


@dataclass
class DrawInstances:
    """Flat draw list (DrawInstance parity)."""

    model_instance: np.ndarray  # (D,) u32
    mesh: np.ndarray  # (D,) u32 flat primitive index
    material: np.ndarray  # (D,) u32


def _process_prim(prim, ranges=None) -> dict:
    """Heavy mesh processing (the loadNextMesh pipeline analog): normal/
    tangent generation, meshlets (the partition, or `ranges`, the one a
    streamed mesh's placeholder was laid out from), bounds — native C++
    when the asset-pipeline library is built (cpp/asset_pipeline.cpp).
    Returns plain arrays for caching."""
    from . import native

    tris = prim.indices.reshape(-1, 3).astype(np.uint32)
    normals = (
        prim.normals
        if prim.normals is not None
        else native.smooth_normals(prim.positions, tris)
    )
    if prim.tangents is not None:
        tangents = prim.tangents
    elif prim.uv0 is not None:
        # MikkTSpace-algorithm tangents (the generateTangents stage,
        # DeferredLoadingContext.cpp:266-338)
        tangents = native.mikktspace_tangents(
            prim.positions, normals.astype(np.float32), prim.uv0, tris
        )
    else:
        tangents = _default_tangents(normals)
    uv0 = (
        prim.uv0
        if prim.uv0 is not None
        else np.zeros((len(prim.positions), 2), np.float32)
    )
    with gprofiler.host("world.meshlets"):
        cl = build_clusters(prim.positions, prim.indices, ranges)
    return quantize_mesh_arrays({
        "positions": prim.positions.astype(np.float32),
        "normals": normals.astype(np.float32),
        "tangents": tangents.astype(np.float32),
        "uv0": uv0.astype(np.float32),
        "tri_vidx": cl.tri_vidx,
        "cluster_offset": cl.cluster_offset,
        "cluster_count": cl.cluster_count,
        "aabb_min": cl.aabb_min,
        "aabb_max": cl.aabb_max,
        "cone_apex": cl.cone_apex,
        "cone_axis": cl.cone_axis,
        "cone_cutoff": cl.cone_cutoff,
        "sphere_radius": cl.sphere_radius,
    })


def quantize_mesh_arrays(a: dict) -> dict:
    """packMeshData analog (DeferredLoadingContext.cpp:442-490 /
    src/scene/Mesh.hpp:11-15): positions f16x4, normals + tangents
    10-10-10-2 snorm, uv f16x2, u16 indices when they fit. Applied to
    EVERY processed primitive (not only cache hits) so rendering is
    independent of cache state; the mesh cache stores these packed forms
    (halves-to-quarters the blob size like the reference's cache v4)."""
    from ..mathx.packing import pack_snorm_10_10_10_2

    out = {k: v for k, v in a.items() if k not in (
        "positions", "normals", "tangents", "uv0", "tri_vidx")}
    pos = a["positions"]
    v_count = len(pos)
    pos4 = np.ones((v_count, 4), np.float16)
    pos4[:, :3] = pos.astype(np.float16)
    out["positions_f16"] = pos4
    n = a["normals"]
    n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    out["normals_1010102"] = pack_snorm_10_10_10_2(n)
    t = a["tangents"]
    t3 = t[:, :3]
    t3 = t3 / np.maximum(np.linalg.norm(t3, axis=-1, keepdims=True), 1e-20)
    out["tangents_1010102"] = pack_snorm_10_10_10_2(t3, t[:, 3])
    out["uv0_f16"] = a["uv0"].astype(np.float16)
    idx = a["tri_vidx"]
    out["tri_vidx"] = idx.astype(
        np.uint16 if v_count <= 65535 else np.uint32
    )
    return out


def dequantize_mesh_arrays(a: dict) -> dict:
    """Unpack quantize_mesh_arrays output to the f32 processing format
    (the GLSL-side decode of the packed vertex formats)."""
    from ..mathx.packing import unpack_snorm_10_10_10_2

    out = {k: v for k, v in a.items() if not (
        k.endswith("_f16") or k.endswith("_1010102"))}
    out["positions"] = np.asarray(a["positions_f16"][:, :3], np.float32)
    n, _w = unpack_snorm_10_10_10_2(np.asarray(a["normals_1010102"]))
    out["normals"] = np.asarray(n, np.float32)
    t3, tw = unpack_snorm_10_10_10_2(np.asarray(a["tangents_1010102"]))
    out["tangents"] = np.concatenate(
        [np.asarray(t3, np.float32), np.asarray(tw, np.float32)[:, None]],
        axis=1,
    )
    out["uv0"] = np.asarray(a["uv0_f16"], np.float32)
    out["tri_vidx"] = a["tri_vidx"].astype(np.uint32)
    return out


def _placeholder_mesh(prim, ranges) -> MeshData:
    """A streamed primitive before its adoption: the clusters of its
    partition `ranges` (meshlets.cluster_ranges of its positions and
    indices, which its adoption builds again from), so the arenas are
    laid out as the adopted mesh fills them, with no triangle in any
    cluster and zero vertices. Unloaded meshes are invisible: tri_count
    0 and degenerate triangles, the meshletCount == 0 gate."""
    n_tris = len(prim.indices) // 3
    offsets = ranges[1]
    n_cl = len(offsets)
    nv = len(prim.positions)
    return MeshData(
        clusters=MeshClusters(
            tri_vidx=np.zeros((n_tris, 3), np.uint32),
            cluster_offset=offsets,
            cluster_count=np.zeros(n_cl, np.uint32),
            aabb_min=np.zeros((n_cl, 3), np.float32),
            aabb_max=np.zeros((n_cl, 3), np.float32),
            cone_apex=np.zeros((n_cl, 3), np.float32),
            cone_axis=np.tile(np.array([[0, 0, 1.0]], np.float32),
                              (n_cl, 1)),
            cone_cutoff=np.ones(n_cl, np.float32),
            sphere_radius=np.zeros(n_cl, np.float32),
        ),
        positions=np.zeros((nv, 3), np.float32),
        normals=np.zeros((nv, 3), np.float32),
        tangents=np.zeros((nv, 4), np.float32),
        uv0=np.zeros((nv, 2), np.float32),
        material=prim.material + 1,
    )


def _load_prim_arrays(path: str, mi: int, pi: int, prim,
                      use_cache: bool, ranges=None) -> dict:
    """A primitive's processed arrays through the versioned mesh cache
    (DeferredLoadingContext readCache/writeCache analog); `ranges`: its
    partition, where already made."""
    from .caches import load_mesh_cache, mesh_cache_path, save_mesh_cache

    arrays = None
    cpath = mesh_cache_path(path, mi, pi) if use_cache else None
    if cpath:
        arrays = load_mesh_cache(cpath)
    if arrays is None:
        arrays = _process_prim(prim, ranges)
        if cpath:
            try:
                save_mesh_cache(cpath, arrays)
            except OSError:
                pass  # read-only scene dir: skip caching
    return arrays


def _mesh_from_arrays(a: dict, material: int) -> MeshData:
    if "positions_f16" in a:
        a = dequantize_mesh_arrays(a)
    return MeshData(
        clusters=MeshClusters(
            tri_vidx=a["tri_vidx"],
            cluster_offset=a["cluster_offset"],
            cluster_count=a["cluster_count"],
            aabb_min=a["aabb_min"],
            aabb_max=a["aabb_max"],
            cone_apex=a["cone_apex"],
            cone_axis=a["cone_axis"],
            cone_cutoff=a["cone_cutoff"],
            sphere_radius=a["sphere_radius"],
        ),
        positions=a["positions"],
        normals=a["normals"],
        tangents=a["tangents"],
        uv0=a["uv0"],
        material=material,
    )


class World:
    """Owns the scene data and produces the per-frame scene dicts."""

    def __init__(
        self,
        path: str,
        scene_index: int | None = None,
        use_cache: bool = True,
        streaming: bool = False,
        instance_grid: int = 1,
    ) -> None:
        _log.info("Loading world %s", path)
        self.path = path
        self.doc: GltfDocument = load_gltf(path)
        self.graph: SceneGraph = build_scene_graph(self.doc, scene_index)
        self.lights: LightArrays = load_lights(self.doc)
        self.materials: MaterialTable = _build_materials(self.doc)

        # Flatten mesh primitives into the reference's flat mesh list
        # (one "mesh" per glTF primitive, WorldData::loadModels), going
        # through the versioned mesh cache (DeferredLoadingContext
        # readCache/writeCache analog).
        self.streaming = streaming
        self._streaming_ctx = None
        self._adopted_textures = []
        self.streaming_dirty = False
        self._use_cache = use_cache
        self.meshes: list[MeshData] = []
        self.model_first_mesh: list[int] = []  # per glTF mesh: first flat index
        # (flat mesh index, glTF mesh, primitive, prim, its partition)
        self._prim_refs = []
        for mi, gltf_mesh in enumerate(self.doc.meshes):
            self.model_first_mesh.append(len(self.meshes))
            for pi, prim in enumerate(gltf_mesh.primitives):
                if streaming:
                    # a layout-only mesh, its geometry adopted later
                    with gprofiler.host("world.meshlets"):
                        ranges = cluster_ranges(prim.positions, prim.indices)
                    self._prim_refs.append((len(self.meshes), mi, pi, prim,
                                            ranges))
                    self.meshes.append(_placeholder_mesh(prim, ranges))
                    continue
                arrays = _load_prim_arrays(path, mi, pi, prim, use_cache)
                self.meshes.append(_mesh_from_arrays(arrays, prim.material + 1))
        self.model_first_mesh.append(len(self.meshes))

        # Vertex-attribute arena (GeometryMetadata-style offsets).
        self.mesh_vertex_offset = np.zeros(len(self.meshes) + 1, np.int64)
        for i, m in enumerate(self.meshes):
            self.mesh_vertex_offset[i + 1] = self.mesh_vertex_offset[i] + m.vertex_count
        self.a_normal = np.concatenate([m.normals for m in self.meshes])
        self.a_tangent = np.concatenate([m.tangents for m in self.meshes])
        self.a_uv = np.concatenate([m.uv0 for m in self.meshes])
        self.a_position = np.concatenate([m.positions for m in self.meshes])
        # interleaved attribute rows, one row gather per vertex fetch:
        # normal3 | tangent4 | uv2 | pad3
        va = len(self.a_normal)
        self.a_packed = np.zeros((va, 12), np.float32)
        self.a_packed[:, 0:3] = self.a_normal
        self.a_packed[:, 3:7] = self.a_tangent
        self.a_packed[:, 7:9] = self.a_uv

        if instance_grid > 1:
            # Scale evidence (BASELINE config 2, Sponza-class): instance
            # the scene on an N x N ground grid through the normal node
            # pipeline — draw instances, world-cluster arena, culling and
            # the per-frame TLAS all scale with it. Spacing from the base
            # scene's world AABB with a small margin.
            from .scene_graph import replicate_graph_grid

            st0 = update_scene(self.graph)
            lo = np.full(3, np.inf, np.float32)
            hi = np.full(3, -np.inf, np.float32)
            for inst, node_idx in enumerate(self.graph.model_instance_nodes):
                gm = self.graph.nodes[node_idx].mesh
                m = st0.model_to_world[inst]
                for mi in range(
                    self.model_first_mesh[gm], self.model_first_mesh[gm + 1]
                ):
                    P = self.meshes[mi].positions
                    if len(P) == 0:
                        continue
                    pl, ph = P.min(axis=0), P.max(axis=0)
                    corners = np.array(
                        [[pl[0], pl[1], pl[2]], [pl[0], pl[1], ph[2]],
                         [pl[0], ph[1], pl[2]], [pl[0], ph[1], ph[2]],
                         [ph[0], pl[1], pl[2]], [ph[0], pl[1], ph[2]],
                         [ph[0], ph[1], pl[2]], [ph[0], ph[1], ph[2]]],
                        np.float32,
                    )
                    w = corners @ m[:3, :3].T + m[:3, 3]
                    lo = np.minimum(lo, w.min(axis=0))
                    hi = np.maximum(hi, w.max(axis=0))
            spacing = (hi - lo) * 1.15
            n = instance_grid
            offsets = [
                np.array([gx * spacing[0], 0.0, gz * spacing[2]], np.float32)
                for gx in range(-(n // 2), n - n // 2)
                for gz in range(-(n // 2), n - n // 2)
                if not (gx == 0 and gz == 0)
            ]
            replicate_graph_grid(self.graph, np.stack(offsets))

        # Draw instances: scene-order flattening of submodels
        # (World.cpp:500-503: order must stay stable for TLAS custom indices).
        mi_nodes = self.graph.model_instance_nodes
        di_model_instance, di_mesh, di_material = [], [], []
        for inst, node_idx in enumerate(mi_nodes):
            gltf_mesh = self.graph.nodes[node_idx].mesh
            first = self.model_first_mesh[gltf_mesh]
            last = self.model_first_mesh[gltf_mesh + 1]
            for mesh_idx in range(first, last):
                di_model_instance.append(inst)
                di_mesh.append(mesh_idx)
                di_material.append(self.meshes[mesh_idx].material)
        self.draw_instances = DrawInstances(
            model_instance=np.array(di_model_instance, np.uint32),
            mesh=np.array(di_mesh, np.uint32),
            material=np.array(di_material, np.uint32),
        )

        self._build_world_tri_arena()

        # Camera defaults (CameraTransform/Parameters defaults,
        # Camera.hpp:22-48) possibly overridden by a scene camera each frame.
        self.camera_params = CameraParameters()
        if self.doc.cameras:
            c = self.doc.cameras[0]
            self.camera_params = CameraParameters(
                fov=c.yfov, z_near=c.znear, z_far=min(c.zfar, 10_000.0)
            )

        self.animation_channels = (
            self.doc.animations[0] if self.doc.animations else []
        )
        self.animation_end_time = anim.animations_end_time(self.animation_channels)

        m = self.meshlet_counters
        _log.info(
            "World: %d meshes, %d draw instances, %d world clusters, %d tris "
            "(padded %d); meshlets: %d built, %d tiles of %d slots, at most "
            "%d vertices, %d min and %.1f mean triangles a cluster",
            len(self.meshes),
            len(self.draw_instances.mesh),
            self.n_world_clusters,
            self.n_real_tris,
            self.n_world_tris,
            m["meshlets"], m["tiles"], CLUSTER_TRI_PAD, m["max_vertices"],
            m["min_triangles"], m["mean_triangles"],
        )

    def _count_meshlets(self) -> None:
        """meshlet_counters of the scene as built: "meshlets" (clusters
        built, once a mesh), "triangles" (real ones, once an instance),
        "tiles" (the arena's 128-slot tiles, a world cluster each),
        "max_vertices" (the most distinct vertices of a cluster),
        "min_triangles" and "mean_triangles" of a world cluster."""
        tri = self.wc_tri_count
        self.meshlet_counters = {
            "meshlets": sum(len(m.cluster_vertices) for m in self.meshes),
            "triangles": int(tri.sum()),
            "tiles": int(self.n_world_clusters),
            "max_vertices": max((int(m.cluster_vertices.max(initial=0))
                                 for m in self.meshes), default=0),
            "min_triangles": int(tri.min()) if len(tri) else 0,
            "mean_triangles": float(tri.sum() / max(len(tri), 1)),
        }

    # ------------------------------------------------------------------
    def _build_world_tri_arena(self) -> None:
        """Static flattened per-DrawInstance geometry, padded to 128-tri tiles.

        Arena slot layout: world cluster c occupies tris
        [c*128, c*128+128); real tris first, degenerate (zero) padding after.
        """
        di = self.draw_instances
        pad = CLUSTER_TRI_PAD
        # count world clusters
        counts = [len(self.meshes[m].clusters.cluster_offset) for m in di.mesh]
        self.n_world_clusters = int(np.sum(counts))
        n_slots = self.n_world_clusters * pad

        wt_p0 = np.zeros((n_slots, 3), np.float32)
        wt_p1 = np.zeros((n_slots, 3), np.float32)
        wt_p2 = np.zeros((n_slots, 3), np.float32)
        wt_aidx = np.zeros((n_slots, 3), np.uint32)
        wt_valid = np.zeros(n_slots, bool)

        wc_instance = np.zeros(self.n_world_clusters, np.uint32)
        wc_mesh = np.zeros(self.n_world_clusters, np.uint32)
        wc_material = np.zeros(self.n_world_clusters, np.uint32)
        wc_local = np.zeros(self.n_world_clusters, np.uint32)  # cluster in mesh
        wc_aabb_min = np.zeros((self.n_world_clusters, 3), np.float32)
        wc_aabb_max = np.zeros((self.n_world_clusters, 3), np.float32)
        # meshlet bounds for the culling pipeline (object space)
        wc_sphere_center = np.zeros((self.n_world_clusters, 3), np.float32)
        wc_sphere_radius = np.zeros(self.n_world_clusters, np.float32)
        wc_cone_axis = np.zeros((self.n_world_clusters, 3), np.float32)
        wc_cone_cutoff = np.zeros(self.n_world_clusters, np.float32)
        wc_tri_count = np.zeros(self.n_world_clusters, np.int32)

        n_real = 0
        c_global = 0
        # flat mesh -> [(its first world cluster, instance)], where
        # poll_streaming writes an adopted mesh
        self._mesh_slots: dict[int, list[tuple[int, int]]] = {}
        for d in range(len(di.mesh)):
            mesh_idx = int(di.mesh[d])
            inst = int(di.model_instance[d])
            mesh = self.meshes[mesh_idx]
            cl = mesh.clusters
            voff = int(self.mesh_vertex_offset[mesh_idx])
            self._mesh_slots.setdefault(mesh_idx, []).append((c_global, inst))
            for local_c in range(len(cl.cluster_offset)):
                s = int(cl.cluster_offset[local_c])
                cnt = int(cl.cluster_count[local_c])
                tris = cl.tri_vidx[s : s + cnt]
                base = c_global * pad
                wt_p0[base : base + cnt] = mesh.positions[tris[:, 0]]
                wt_p1[base : base + cnt] = mesh.positions[tris[:, 1]]
                wt_p2[base : base + cnt] = mesh.positions[tris[:, 2]]
                wt_aidx[base : base + cnt] = tris + np.uint32(voff)
                wt_valid[base : base + cnt] = True
                wc_instance[c_global] = inst
                wc_mesh[c_global] = mesh_idx
                wc_material[c_global] = mesh.material
                wc_local[c_global] = local_c
                wc_aabb_min[c_global] = cl.aabb_min[local_c]
                wc_aabb_max[c_global] = cl.aabb_max[local_c]
                wc_sphere_center[c_global] = cl.cone_apex[local_c]
                wc_sphere_radius[c_global] = cl.sphere_radius[local_c]
                wc_cone_axis[c_global] = cl.cone_axis[local_c]
                wc_cone_cutoff[c_global] = cl.cone_cutoff[local_c]
                wc_tri_count[c_global] = cnt
                n_real += cnt
                c_global += 1

        self.n_real_tris = n_real
        self.n_world_tris = n_slots
        self.wt_p0, self.wt_p1, self.wt_p2 = wt_p0, wt_p1, wt_p2
        self.wt_aidx = wt_aidx
        self.wt_valid = wt_valid
        self.wc_instance = wc_instance
        self.wc_mesh = wc_mesh
        self.wc_material = wc_material
        self.wc_aabb_min_obj = wc_aabb_min
        self.wc_aabb_max_obj = wc_aabb_max
        self.wc_sphere_center = wc_sphere_center
        self.wc_sphere_radius = wc_sphere_radius
        self.wc_cone_axis = wc_cone_axis
        self.wc_cone_cutoff = wc_cone_cutoff
        self.wc_tri_count = wc_tri_count
        # per-tri instance/material (cluster-uniform, broadcast to slots)
        self.wt_instance = np.repeat(wc_instance, pad)
        self.wt_material = np.repeat(wc_material, pad)
        self._count_meshlets()

    # ------------------------------------------------------------------
    def static_scene_arrays(self) -> dict[str, np.ndarray]:
        """Arrays that do not change frame to frame (upload once)."""
        return {
            "wt_p0": self.wt_p0,
            "wt_p1": self.wt_p1,
            "wt_p2": self.wt_p2,
            "wt_aidx": self.wt_aidx.astype(np.int32),
            "wt_instance": self.wt_instance.astype(np.int32),
            "wt_material": self.wt_material.astype(np.int32),
            "wc_instance": self.wc_instance.astype(np.int32),
            "wc_material": self.wc_material.astype(np.int32),
            "wc_sphere_center": self.wc_sphere_center,
            "wc_sphere_radius": self.wc_sphere_radius,
            "wc_cone_axis": self.wc_cone_axis,
            "wc_cone_cutoff": self.wc_cone_cutoff,
            "wc_tri_count": self.wc_tri_count,
            "a_packed": self.a_packed,
            "materials": self.materials.uniforms(),
        }

    def frame_arrays(self, time_s: float = 0.0) -> dict:
        """Per-frame scene state: transforms, lights, BVH (TLAS analog)."""
        animated = anim.update_animations(self.animation_channels, time_s)
        st = update_scene(self.graph, animated)

        # lights positions/directions from the graph
        la = self.lights
        if st.dir_light_direction is not None:
            la.dir_direction = st.dir_light_direction
        la.point_position[: len(st.point_positions)] = st.point_positions
        la.spot_position[: len(st.spot_positions)] = st.spot_positions
        la.spot_direction[: len(st.spot_directions)] = st.spot_directions

        # World-space cluster AABBs -> BVH rebuild (per-frame TLAS parity)
        n_inst = max(len(st.model_to_world), 1)
        m2w = (
            st.model_to_world
            if len(st.model_to_world)
            else np.eye(4, dtype=np.float32)[None]
        )
        wmin = np.empty_like(self.wc_aabb_min_obj)
        wmax = np.empty_like(self.wc_aabb_max_obj)
        for inst in range(n_inst):
            sel = self.wc_instance == inst
            if not np.any(sel):
                continue
            wmin[sel], wmax[sel] = transform_aabbs(
                self.wc_aabb_min_obj[sel], self.wc_aabb_max_obj[sel], m2w[inst]
            )
        bvh: Bvh = build_bvh(wmin, wmax, max_leaf_size=1)
        bvh_bounds, bvh_meta = pack_nodes(bvh)
        bvh_nodes8 = pack_nodes8(bvh)
        from ..ops.trace_bvh import STACK8_CAP, STACK_CAP

        assert bvh.depth + 2 <= STACK_CAP, "scene exceeds BVH stack depth"
        assert 7 * nodes8_depth(bvh_nodes8) + 1 <= STACK8_CAP, (
            "scene exceeds the 8-wide stack depth")

        transforms = m2w[:, :3, :4].astype(np.float32)
        normal_ms = (
            st.normal_to_world[:, :3, :3].astype(np.float32)
            if len(st.normal_to_world)
            else np.eye(3, dtype=np.float32)[None]
        )

        inst_packed = np.concatenate(
            [transforms.reshape(len(transforms), 12),
             normal_ms.reshape(len(normal_ms), 9)],
            axis=1,
        ).astype(np.float32)

        return {
            "wc_aabb_min_w": wmin,  # (C, 3) world-space cluster AABBs
            "wc_aabb_max_w": wmax,
            "inst_packed": inst_packed,  # (I, 21): 3x4 | 3x3 rows
            "transforms": transforms,  # (I, 3, 4)
            "normal_transforms": normal_ms,  # (I, 3, 3)
            "bvh_bounds": bvh_bounds,  # (N, 6) kernel node bounds
            "bvh_meta": bvh_meta,  # (N, 3) left | right | leaf cluster
            "bvh_nodes8": bvh_nodes8,  # (N8, 8, 8) 8-wide node table
            "bvh_depth": bvh.depth,
            "lights": light_uniforms(la),
            "scene_camera": st.camera,
        }

    # ------------------------------------------------------------------
    # Asset streaming (DeferredLoadingContext analog)

    def start_streaming(self, texture_jobs=None) -> None:
        """Launch the background loading worker (World::startFrame on the
        first frame). texture_jobs (textures.build_streaming_arena's)
        stream after the meshes (loadNextTexture's order)."""
        if not self.streaming or self._streaming_ctx is not None:
            return
        from .streaming import LoadedMesh, StreamingContext

        def make_job(flat_idx, mi, pi, prim, ranges):
            def job():
                return LoadedMesh(
                    mesh_index=flat_idx,
                    arrays=_load_prim_arrays(self.path, mi, pi, prim,
                                             self._use_cache, ranges))

            return job

        jobs = [make_job(*ref) for ref in self._prim_refs]
        self._streaming_ctx = StreamingContext(jobs, texture_jobs or [])
        self._streaming_ctx.start()
        self._adopted_textures = []

    def take_adopted_textures(self) -> list:
        """The LoadedTexture items adopted by poll_streaming since the last
        call (the pollTextureWorker handoff); the caller writes them into
        its arena (textures.arena_write)."""
        out = self._adopted_textures
        self._adopted_textures = []
        return out

    def poll_streaming(self, budget: int | None = None) -> int:
        """Adopt finished meshes into the host arrays (pollMeshWorker) and
        queue finished textures for take_adopted_textures. Returns the
        number adopted; sets streaming_dirty when a mesh changed the
        static arrays."""
        if self._streaming_ctx is None:
            return 0
        from .streaming import MAX_ADOPTIONS_PER_FRAME, LoadedTexture

        polled = self._streaming_ctx.poll(budget or MAX_ADOPTIONS_PER_FRAME)
        self._adopted_textures.extend(
            i for i in polled if isinstance(i, LoadedTexture))
        adopted = [i for i in polled if not isinstance(i, LoadedTexture)]
        pad = CLUSTER_TRI_PAD
        for item in adopted:
            mesh_idx = item.mesh_index
            mesh = _mesh_from_arrays(item.arrays,
                                     self.meshes[mesh_idx].material)
            cl = mesh.clusters
            if len(cl.cluster_offset) != len(
                    self.meshes[mesh_idx].clusters.cluster_offset):
                raise ValueError(
                    f"mesh {mesh_idx}: {len(cl.cluster_offset)} clusters "
                    "adopted where its placeholder laid out "
                    f"{len(self.meshes[mesh_idx].clusters.cluster_offset)}")
            self.meshes[mesh_idx] = mesh
            voff = int(self.mesh_vertex_offset[mesh_idx])
            nv = mesh.vertex_count
            self.a_packed[voff : voff + nv, 0:3] = mesh.normals
            self.a_packed[voff : voff + nv, 3:7] = mesh.tangents
            self.a_packed[voff : voff + nv, 7:9] = mesh.uv0
            for c_base, _inst in self._mesh_slots.get(mesh_idx, []):
                for local_c in range(len(cl.cluster_offset)):
                    s0 = int(cl.cluster_offset[local_c])
                    cnt = int(cl.cluster_count[local_c])
                    tris = cl.tri_vidx[s0 : s0 + cnt]
                    base = (c_base + local_c) * pad
                    self.wt_p0[base : base + cnt] = mesh.positions[tris[:, 0]]
                    self.wt_p1[base : base + cnt] = mesh.positions[tris[:, 1]]
                    self.wt_p2[base : base + cnt] = mesh.positions[tris[:, 2]]
                    self.wt_aidx[base : base + cnt] = tris + np.uint32(voff)
                    cg = c_base + local_c
                    self.wc_aabb_min_obj[cg] = cl.aabb_min[local_c]
                    self.wc_aabb_max_obj[cg] = cl.aabb_max[local_c]
                    self.wc_sphere_center[cg] = cl.cone_apex[local_c]
                    self.wc_sphere_radius[cg] = cl.sphere_radius[local_c]
                    self.wc_cone_axis[cg] = cl.cone_axis[local_c]
                    self.wc_cone_cutoff[cg] = cl.cone_cutoff[local_c]
                    self.wc_tri_count[cg] = cnt
        if adopted:
            self.streaming_dirty = True
            self._count_meshlets()
        return len(polled)

    @property
    def streaming_done(self) -> bool:
        return self._streaming_ctx is None or self._streaming_ctx.done

    def make_camera(
        self, resolution: tuple[int, int], apply_jitter: bool = False
    ) -> Camera:
        cam = Camera(resolution, self.camera_params, apply_jitter=apply_jitter)
        st = update_scene(self.graph, {})
        if st.camera is not None:
            cam.look_at(
                CameraTransform(eye=st.camera.eye, target=st.camera.target, up=st.camera.up)
            )
        return cam
