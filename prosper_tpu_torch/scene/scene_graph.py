"""A copy of prosper_tpu/scene/scene_graph.py (numpy), kept in the port so that it
imports nothing of the JAX package.

Scene graph + per-frame transform propagation.

The reference walks the node hierarchy iteratively each frame, composing
TRS into modelToWorld/normalToWorld and extracting camera/light transforms
(World::updateScene, the reference's src/scene/World.cpp:359-466). We keep
the same single-pass DFS on the host (numpy) and emit flat per-instance
transform arrays for upload.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..mathx import transforms as T
from .gltf import GltfDocument


@dataclass
class SceneNode:
    """Flattened scene node (reference Scene.hpp:25-44)."""

    gltf_index: int
    children: list[int] = field(default_factory=list)
    translation: np.ndarray | None = None
    rotation: np.ndarray | None = None
    scale: np.ndarray | None = None
    model_instance: int | None = None  # index into model_instances
    mesh: int | None = None  # glTF mesh (model) index
    camera: int | None = None
    directional_light: bool = False
    point_light: int | None = None  # index into point light array
    spot_light: int | None = None
    dynamic_transform: bool = False


@dataclass
class CameraPose:
    eye: np.ndarray
    target: np.ndarray
    up: np.ndarray


@dataclass
class SceneGraph:
    nodes: list[SceneNode]
    roots: list[int]
    model_instance_nodes: list[int]  # node index per model instance
    n_point_lights: int
    n_spot_lights: int
    has_directional: bool
    camera_node: int | None


def build_scene_graph(doc: GltfDocument, scene_index: int | None = None) -> SceneGraph:
    """Flatten the glTF default scene like WorldData::loadScenes."""
    scene_index = doc.default_scene if scene_index is None else scene_index
    roots = doc.scenes[scene_index] if doc.scenes else []

    nodes: list[SceneNode] = []
    model_instance_nodes: list[int] = []
    n_point = n_spot = 0
    has_dir = False
    camera_node: int | None = None

    # Collect the transitive closure of the scene's nodes, preserving glTF
    # node indices for animation targeting.
    index_map: dict[int, int] = {}

    def visit(gi: int) -> int:
        if gi in index_map:
            return index_map[gi]
        g = doc.nodes[gi]
        sn = SceneNode(
            gltf_index=gi,
            translation=g.translation,
            rotation=g.rotation,
            scale=g.scale,
            mesh=g.mesh,
            camera=g.camera,
        )
        idx = len(nodes)
        nodes.append(sn)
        index_map[gi] = idx
        if g.mesh is not None:
            sn.model_instance = len(model_instance_nodes)
            model_instance_nodes.append(idx)
        nonlocal n_point, n_spot, has_dir, camera_node
        if g.camera is not None and camera_node is None:
            camera_node = idx
        if g.light is not None and g.light < len(doc.lights):
            light = doc.lights[g.light]
            if light.kind == "directional":
                # only one supported (WorldData.cpp:1459-1466)
                if not has_dir:
                    sn.directional_light = True
                    has_dir = True
            elif light.kind == "point":
                sn.point_light = n_point
                n_point += 1
            elif light.kind == "spot":
                sn.spot_light = n_spot
                n_spot += 1
        sn.children = [visit(c) for c in g.children]
        return idx

    root_idxs = [visit(r) for r in roots]

    # Mark dynamic transforms: animated nodes and their subtrees
    graph = SceneGraph(
        nodes=nodes,
        roots=root_idxs,
        model_instance_nodes=model_instance_nodes,
        n_point_lights=n_point,
        n_spot_lights=n_spot,
        has_directional=has_dir,
        camera_node=camera_node,
    )
    animated_gltf = {
        ch.node for anim in doc.animations for ch in anim
    }
    def mark_dynamic(idx: int, inherited: bool) -> None:
        n = nodes[idx]
        dyn = inherited or (n.gltf_index in animated_gltf)
        n.dynamic_transform = dyn
        for c in n.children:
            mark_dynamic(c, dyn)

    for r in root_idxs:
        mark_dynamic(r, False)
    return graph


def replicate_graph_grid(graph: SceneGraph, offsets: np.ndarray) -> None:
    """Instance the whole scene at each world-space offset (in place).

    Scale-evidence path (BASELINE config 2 / Sponza-class scenes without
    the asset): every node subtree is duplicated per offset with the
    offset folded into the copied roots' translations, extending
    model_instance_nodes — draw instances, the world-cluster arena and
    the per-frame TLAS all scale with it through the normal pipeline.
    Copies share gltf_index, so animations drive every replica; light
    and camera markers are stripped from copies (light caps stay
    honest, the camera stays unique)."""
    base_nodes = list(graph.nodes)
    base_roots = list(graph.roots)
    for off in np.asarray(offsets, np.float32):
        remap: dict[int, int] = {}

        def copy(idx: int) -> int:
            if idx in remap:
                return remap[idx]
            b = base_nodes[idx]
            sn = SceneNode(
                gltf_index=b.gltf_index,
                translation=None if b.translation is None else b.translation.copy(),
                rotation=None if b.rotation is None else b.rotation.copy(),
                scale=None if b.scale is None else b.scale.copy(),
                mesh=b.mesh,
                dynamic_transform=b.dynamic_transform,
            )
            new_idx = len(graph.nodes)
            graph.nodes.append(sn)
            remap[idx] = new_idx
            if b.mesh is not None:
                sn.model_instance = len(graph.model_instance_nodes)
                graph.model_instance_nodes.append(new_idx)
            sn.children = [copy(c) for c in b.children]
            return new_idx

        # synthetic offset parent (gltf_index -1 -> never animated; an
        # animated root's translation channel would otherwise overwrite
        # a folded-in offset and collapse replicas onto the original)
        wrapper = SceneNode(
            gltf_index=-1,
            translation=off.copy(),
            children=[copy(r) for r in base_roots],
        )
        graph.nodes.append(wrapper)
        graph.roots.append(len(graph.nodes) - 1)


@dataclass
class SceneTransforms:
    """Flat per-frame outputs of the updateScene DFS."""

    model_to_world: np.ndarray  # (I, 4, 4)
    normal_to_world: np.ndarray  # (I, 4, 4)
    uniform_scales: np.ndarray  # (I,) max |column scale| like maxViewScale
    camera: CameraPose | None
    dir_light_direction: np.ndarray | None  # (3,)
    point_positions: np.ndarray  # (P, 3)
    spot_positions: np.ndarray  # (S, 3)
    spot_directions: np.ndarray  # (S, 3)


def update_scene(
    graph: SceneGraph,
    animated: dict[tuple[int, str], np.ndarray] | None = None,
) -> SceneTransforms:
    """Compose TRS down the hierarchy (World.cpp:359-466).

    `animated` overrides node TRS components by (gltf node index, path).
    """
    animated = animated or {}
    n_inst = len(graph.model_instance_nodes)
    model_to_world = np.tile(np.eye(4, dtype=np.float32), (max(n_inst, 1), 1, 1))[
        :n_inst
    ]
    normal_to_world = model_to_world.copy()
    uniform_scales = np.ones(n_inst, np.float32)
    camera: CameraPose | None = None
    dir_dir: np.ndarray | None = None
    point_pos = np.zeros((graph.n_point_lights, 3), np.float32)
    spot_pos = np.zeros((graph.n_spot_lights, 3), np.float32)
    spot_dir = np.zeros((graph.n_spot_lights, 3), np.float32)

    # Iterative DFS with explicit parent-transform stack, like the reference
    stack = [(r, np.eye(4, dtype=np.float32)) for r in reversed(graph.roots)]
    while stack:
        idx, parent = stack.pop()
        node = graph.nodes[idx]
        t = animated.get((node.gltf_index, "translation"), node.translation)
        r = animated.get((node.gltf_index, "rotation"), node.rotation)
        s = animated.get((node.gltf_index, "scale"), node.scale)
        if t is None and r is None and s is None:
            m = parent
        else:
            local = T.trs_to_mat4(
                np.zeros(3, np.float32) if t is None else np.asarray(t, np.float32),
                np.array([0, 0, 0, 1], np.float32) if r is None else np.asarray(r, np.float32),
                np.ones(3, np.float32) if s is None else np.asarray(s, np.float32),
            )
            m = parent @ local

        if node.model_instance is not None:
            mi = node.model_instance
            model_to_world[mi] = m
            normal_to_world[mi] = T.normal_matrix(m)
            col_scales = np.linalg.norm(m[:3, :3], axis=0)
            uniform_scales[mi] = float(np.max(col_scales))

        if node.camera is not None and camera is None:
            eye = (m @ np.array([0, 0, 0, 1.0], np.float32))[:3]
            target = (m @ np.array([0, 0, -1.0, 1.0], np.float32))[:3]
            up = m[:3, :3] @ np.array([0, 1.0, 0], np.float32)
            camera = CameraPose(eye=eye, target=target, up=up)

        if node.directional_light:
            dir_dir = m[:3, :3] @ np.array([0, 0, -1.0], np.float32)

        if node.point_light is not None:
            point_pos[node.point_light] = (m @ np.array([0, 0, 0, 1.0], np.float32))[:3]

        if node.spot_light is not None:
            spot_pos[node.spot_light] = (m @ np.array([0, 0, 0, 1.0], np.float32))[:3]
            spot_dir[node.spot_light] = m[:3, :3] @ np.array([0, 0, -1.0], np.float32)

        for c in reversed(node.children):
            stack.append((c, m))

    return SceneTransforms(
        model_to_world=model_to_world,
        normal_to_world=normal_to_world,
        uniform_scales=uniform_scales,
        camera=camera,
        dir_light_direction=dir_dir,
        point_positions=point_pos,
        spot_positions=spot_pos,
        spot_directions=spot_dir,
    )
