"""A copy of prosper_tpu/scene/gltf.py (numpy), kept in the port so that it
imports nothing of the JAX package.

glTF 2.0 loader (numpy): the cgltf-equivalent of the reference.

Parses .gltf/.glb into plain-numpy documents covering everything the
reference consumes (WorldData.cpp loadTextures/Materials/Models/Animations/
Scenes):
- mesh primitives: POSITION/NORMAL/TANGENT/TEXCOORD_0 + indices
- materials: pbrMetallicRoughness (+ alphaMode/cutoff, normal texture)
- node hierarchy with TRS or decomposed matrix
  (the reference's src/scene/WorldData.cpp:1178-1212: matrix decompose,
  near-identity components dropped)
- KHR_lights_punctual with the reference's W -> radiance conventions
  (WorldData.cpp:1456-1530)
- perspective cameras
- animations: step/linear/cubicspline channels on node TRS

No instructions are taken from the reference; only observable behavior is
reproduced.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from dataclasses import dataclass, field

import numpy as np

# glTF componentType -> numpy dtype
_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {
    "SCALAR": 1,
    "VEC2": 2,
    "VEC3": 3,
    "VEC4": 4,
    "MAT2": 4,
    "MAT3": 9,
    "MAT4": 16,
}


@dataclass
class GltfPrimitive:
    positions: np.ndarray  # (N,3) f32
    normals: np.ndarray | None  # (N,3) f32
    tangents: np.ndarray | None  # (N,4) f32 (xyz + handedness sign w)
    uv0: np.ndarray | None  # (N,2) f32
    indices: np.ndarray  # (M,) u32
    material: int  # index into materials; -1 -> default material 0


@dataclass
class GltfMesh:
    name: str
    primitives: list[GltfPrimitive]


@dataclass
class GltfTextureRef:
    image: int = -1  # image index, -1 = none
    sampler: int = -1


@dataclass
class GltfMaterial:
    name: str = ""
    base_color_factor: np.ndarray = field(
        default_factory=lambda: np.ones(4, np.float32)
    )
    metallic_factor: float = 1.0
    roughness_factor: float = 1.0
    alpha_mode: int = 0  # 0 opaque, 1 mask, 2 blend (MaterialData AlphaMode)
    alpha_cutoff: float = 0.5
    base_color_texture: GltfTextureRef = field(default_factory=GltfTextureRef)
    metallic_roughness_texture: GltfTextureRef = field(default_factory=GltfTextureRef)
    normal_texture: GltfTextureRef = field(default_factory=GltfTextureRef)


@dataclass
class GltfSampler:
    mag_filter: int = 9729  # LINEAR
    min_filter: int = 9987  # LINEAR_MIPMAP_LINEAR
    wrap_s: int = 10497  # REPEAT
    wrap_t: int = 10497


@dataclass
class GltfImage:
    uri: str | None
    data: bytes | None  # embedded / bufferView payload
    mime: str | None


@dataclass
class GltfLight:
    kind: str  # 'directional' | 'point' | 'spot'
    color: np.ndarray
    intensity: float
    range: float
    inner_cone_angle: float
    outer_cone_angle: float


@dataclass
class GltfCamera:
    yfov: float
    znear: float
    zfar: float


@dataclass
class GltfNode:
    name: str
    children: list[int]
    mesh: int | None
    camera: int | None
    light: int | None
    translation: np.ndarray | None
    rotation: np.ndarray | None  # quaternion (x,y,z,w)
    scale: np.ndarray | None


@dataclass
class GltfAnimationChannel:
    node: int
    path: str  # 'translation' | 'rotation' | 'scale'
    interpolation: str  # 'STEP' | 'LINEAR' | 'CUBICSPLINE'
    times: np.ndarray  # (K,) f32
    values: np.ndarray  # (K, C) or (K*3, C) for cubic spline


@dataclass
class GltfDocument:
    meshes: list[GltfMesh]
    materials: list[GltfMaterial]
    samplers: list[GltfSampler]
    textures: list[GltfTextureRef]
    images: list[GltfImage]
    nodes: list[GltfNode]
    scenes: list[list[int]]  # root node indices per scene
    default_scene: int
    lights: list[GltfLight]
    cameras: list[GltfCamera]
    animations: list[list[GltfAnimationChannel]]
    base_dir: str

    # Which images are sRGB vs linear, classified exactly like the
    # reference's loadTextures (WorldData.cpp:681-755): baseColor reads
    # sRGB, normal/metallicRoughness read linear.
    def image_color_spaces(self) -> list[str]:
        spaces = ["linear"] * len(self.images)
        for m in self.materials:
            t = m.base_color_texture
            if t.image >= 0:
                spaces[t.image] = "srgb"
        return spaces

    def image_wrap_modes(self) -> list[tuple[int, int]]:
        """Per-image (wrap_u, wrap_v) codes: 0 REPEAT, 1 CLAMP_TO_EDGE,
        2 MIRRORED_REPEAT (materials.glsl sampler wrap; first referencing
        material texture wins — the texture arena is keyed by image, so
        two textures sharing an image with different samplers collapse to
        one mode, which no bundled scene does)."""
        gl = {10497: 0, 33071: 1, 33069: 1, 33648: 2}
        modes: list[tuple[int, int] | None] = [None] * len(self.images)
        for m in self.materials:
            for t in (
                m.base_color_texture,
                m.metallic_roughness_texture,
                m.normal_texture,
            ):
                if t.image >= 0 and modes[t.image] is None:
                    if 0 <= t.sampler < len(self.samplers):
                        s = self.samplers[t.sampler]
                        modes[t.image] = (
                            gl.get(s.wrap_s, 0),
                            gl.get(s.wrap_t, 0),
                        )
                    else:
                        modes[t.image] = (0, 0)
        return [m if m is not None else (0, 0) for m in modes]


def _decompose_trs(m: np.ndarray):
    """Decompose a 4x4 into T/R/S (spec guarantees decomposability;
    WorldData.cpp:1182-1189)."""
    t = m[:3, 3].copy()
    rs = m[:3, :3]
    s = np.linalg.norm(rs, axis=0)
    # guard mirrored scale via determinant sign on x
    if np.linalg.det(rs) < 0:
        s[0] = -s[0]
    r = rs / s[None, :]
    # matrix -> quaternion
    tr = np.trace(r)
    if tr > 0:
        w = np.sqrt(1.0 + tr) / 2
        x = (r[2, 1] - r[1, 2]) / (4 * w)
        y = (r[0, 2] - r[2, 0]) / (4 * w)
        z = (r[1, 0] - r[0, 1]) / (4 * w)
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        q = np.zeros(4)
        q[i] = np.sqrt(max(0.0, 1.0 + r[i, i] - r[j, j] - r[k, k])) / 2
        q[j] = (r[j, i] + r[i, j]) / (4 * q[i])
        q[k] = (r[k, i] + r[i, k]) / (4 * q[i])
        q[3] = (r[k, j] - r[j, k]) / (4 * q[i])
        x, y, z, w = q
    quat = np.array([x, y, z, w], np.float32)
    return t.astype(np.float32), quat, s.astype(np.float32)


class _BufferCache:
    def __init__(self, gltf: dict, base_dir: str, glb_bin: bytes | None):
        self._gltf = gltf
        self._base_dir = base_dir
        self._glb_bin = glb_bin
        self._buffers: dict[int, bytes] = {}

    def buffer(self, i: int) -> bytes:
        if i in self._buffers:
            return self._buffers[i]
        spec = self._gltf["buffers"][i]
        uri = spec.get("uri")
        if uri is None:
            data = self._glb_bin
            if data is None:
                raise ValueError("buffer without uri outside GLB")
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self._base_dir, uri), "rb") as f:
                data = f.read()
        self._buffers[i] = data
        return data

    def accessor(self, i: int) -> np.ndarray:
        """Read accessor i as (count, components) array in its natural dtype,
        honouring bufferView byteStride and sparse accessors."""
        acc = self._gltf["accessors"][i]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        itemsize = np.dtype(dtype).itemsize * ncomp

        if "bufferView" in acc:
            bv = self._gltf["bufferViews"][acc["bufferView"]]
            buf = self.buffer(bv["buffer"])
            start = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", itemsize)
            if stride == itemsize:
                out = np.frombuffer(
                    buf, dtype=dtype, count=count * ncomp, offset=start
                ).reshape(count, ncomp)
            else:
                raw = np.frombuffer(
                    buf,
                    dtype=np.uint8,
                    count=stride * (count - 1) + itemsize,
                    offset=start,
                )
                strided = np.lib.stride_tricks.as_strided(
                    raw, shape=(count, itemsize), strides=(stride, 1)
                )
                out = strided.copy().view(dtype).reshape(count, ncomp)
        else:
            out = np.zeros((count, ncomp), dtype)

        sparse = acc.get("sparse")
        if sparse is not None:
            out = out.copy()
            sc = sparse["count"]
            idx_spec = sparse["indices"]
            ibv = self._gltf["bufferViews"][idx_spec["bufferView"]]
            ibuf = self.buffer(ibv["buffer"])
            idt = _COMPONENT_DTYPES[idx_spec["componentType"]]
            ioff = ibv.get("byteOffset", 0) + idx_spec.get("byteOffset", 0)
            idxs = np.frombuffer(ibuf, dtype=idt, count=sc, offset=ioff)
            val_spec = sparse["values"]
            vbv = self._gltf["bufferViews"][val_spec["bufferView"]]
            vbuf = self.buffer(vbv["buffer"])
            voff = vbv.get("byteOffset", 0) + val_spec.get("byteOffset", 0)
            vals = np.frombuffer(
                vbuf, dtype=dtype, count=sc * ncomp, offset=voff
            ).reshape(sc, ncomp)
            out[idxs] = vals
        return out

    def accessor_f32(self, i: int) -> np.ndarray:
        """Accessor as float32 with KHR_mesh_quantization-style normalisation."""
        acc = self._gltf["accessors"][i]
        arr = self.accessor(i)
        if arr.dtype == np.float32:
            return arr
        if acc.get("normalized", False):
            info = np.iinfo(arr.dtype)
            if info.min < 0:
                return np.maximum(arr.astype(np.float32) / info.max, -1.0)
            return arr.astype(np.float32) / info.max
        return arr.astype(np.float32)

    def image_bytes(self, img_spec: dict) -> tuple[str | None, bytes | None, str | None]:
        uri = img_spec.get("uri")
        mime = img_spec.get("mimeType")
        if uri is not None and not uri.startswith("data:"):
            return uri, None, mime
        if uri is not None:
            return None, base64.b64decode(uri.split(",", 1)[1]), mime
        bv = self._gltf["bufferViews"][img_spec["bufferView"]]
        buf = self.buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        return None, buf[off : off + bv["byteLength"]], mime


def _texture_ref(gltf: dict, tex_info: dict | None) -> GltfTextureRef:
    if tex_info is None:
        return GltfTextureRef()
    tex = gltf["textures"][tex_info["index"]]
    return GltfTextureRef(
        image=tex.get("source", -1), sampler=tex.get("sampler", -1)
    )


def load_gltf(path: str) -> GltfDocument:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_bin = None
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            magic, _version, _length = struct.unpack("<3I", f.read(12))
            if magic != 0x46546C67:
                raise ValueError("bad GLB magic")
            gltf = None
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<2I", hdr)
                payload = f.read(clen)
                if ctype == 0x4E4F534A:  # JSON
                    gltf = json.loads(payload)
                elif ctype == 0x004E4942:  # BIN
                    glb_bin = payload
        assert gltf is not None
    else:
        with open(path) as f:
            gltf = json.load(f)

    bufs = _BufferCache(gltf, base_dir, glb_bin)

    # --- meshes -----------------------------------------------------------
    meshes: list[GltfMesh] = []
    for mesh_spec in gltf.get("meshes", []):
        prims = []
        for p in mesh_spec.get("primitives", []):
            if p.get("mode", 4) != 4:  # TRIANGLES only, like the reference
                continue
            attrs = p["attributes"]
            positions = bufs.accessor_f32(attrs["POSITION"])[:, :3]
            normals = (
                bufs.accessor_f32(attrs["NORMAL"])[:, :3]
                if "NORMAL" in attrs
                else None
            )
            tangents = (
                bufs.accessor_f32(attrs["TANGENT"])[:, :4]
                if "TANGENT" in attrs
                else None
            )
            uv0 = (
                bufs.accessor_f32(attrs["TEXCOORD_0"])[:, :2]
                if "TEXCOORD_0" in attrs
                else None
            )
            if "indices" in p:
                indices = bufs.accessor(p["indices"]).reshape(-1).astype(np.uint32)
            else:
                indices = np.arange(len(positions), dtype=np.uint32)
            prims.append(
                GltfPrimitive(
                    positions=np.ascontiguousarray(positions),
                    normals=None if normals is None else np.ascontiguousarray(normals),
                    tangents=None
                    if tangents is None
                    else np.ascontiguousarray(tangents),
                    uv0=None if uv0 is None else np.ascontiguousarray(uv0),
                    indices=indices,
                    material=p.get("material", -1),
                )
            )
        meshes.append(GltfMesh(name=mesh_spec.get("name", ""), primitives=prims))

    # --- materials ---------------------------------------------------------
    alpha_modes = {"OPAQUE": 0, "MASK": 1, "BLEND": 2}
    materials: list[GltfMaterial] = []
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        materials.append(
            GltfMaterial(
                name=m.get("name", ""),
                base_color_factor=np.array(
                    pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
                ),
                metallic_factor=float(pbr.get("metallicFactor", 1.0)),
                roughness_factor=float(pbr.get("roughnessFactor", 1.0)),
                alpha_mode=alpha_modes.get(m.get("alphaMode", "OPAQUE"), 0),
                alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
                base_color_texture=_texture_ref(gltf, pbr.get("baseColorTexture")),
                metallic_roughness_texture=_texture_ref(
                    gltf, pbr.get("metallicRoughnessTexture")
                ),
                normal_texture=_texture_ref(gltf, m.get("normalTexture")),
            )
        )

    # --- samplers / textures / images --------------------------------------
    samplers = [
        GltfSampler(
            mag_filter=s.get("magFilter", 9729),
            min_filter=s.get("minFilter", 9987),
            wrap_s=s.get("wrapS", 10497),
            wrap_t=s.get("wrapT", 10497),
        )
        for s in gltf.get("samplers", [])
    ]
    textures = [
        GltfTextureRef(image=t.get("source", -1), sampler=t.get("sampler", -1))
        for t in gltf.get("textures", [])
    ]
    images = []
    for img_spec in gltf.get("images", []):
        uri, data, mime = bufs.image_bytes(img_spec)
        images.append(GltfImage(uri=uri, data=data, mime=mime))

    # --- lights (KHR_lights_punctual) ---------------------------------------
    lights: list[GltfLight] = []
    ext = gltf.get("extensions", {}).get("KHR_lights_punctual", {})
    for l in ext.get("lights", []):
        spot = l.get("spot", {})
        lights.append(
            GltfLight(
                kind=l["type"],
                color=np.array(l.get("color", [1, 1, 1]), np.float32),
                intensity=float(l.get("intensity", 1.0)),
                range=float(l.get("range", 0.0)),
                inner_cone_angle=float(spot.get("innerConeAngle", 0.0)),
                outer_cone_angle=float(spot.get("outerConeAngle", np.pi / 4)),
            )
        )

    # --- cameras -------------------------------------------------------------
    cameras = []
    for c in gltf.get("cameras", []):
        if c.get("type") != "perspective":
            cameras.append(GltfCamera(yfov=np.pi / 3, znear=0.1, zfar=500.0))
            continue
        p = c["perspective"]
        cameras.append(
            GltfCamera(
                yfov=float(p.get("yfov", np.pi / 3)),
                znear=float(p.get("znear", 0.1)),
                zfar=float(p.get("zfar", 500.0)),
            )
        )

    # --- nodes ---------------------------------------------------------------
    # Near-identity TRS components are dropped like the reference
    # (WorldData.cpp:1198-1212) so static nodes skip transform math.
    thr = 0.001
    nodes: list[GltfNode] = []
    for n in gltf.get("nodes", []):
        t = r = s = None
        if "matrix" in n:
            m = np.array(n["matrix"], np.float32).reshape(4, 4).T  # column major
            t, r, s = _decompose_trs(m)
        if "translation" in n:
            t = np.array(n["translation"], np.float32)
        if "rotation" in n:
            r = np.array(n["rotation"], np.float32)  # (x,y,z,w)
        if "scale" in n:
            s = np.array(n["scale"], np.float32)
        if t is not None and np.all(np.abs(t) <= thr):
            t = None
        if r is not None:
            # compare via rotation angle
            ang = 2 * np.arccos(np.clip(abs(r[3]), 0, 1))
            if ang <= thr:
                r = None
        if s is not None and np.all(np.abs(s - 1.0) <= thr):
            s = None
        light = n.get("extensions", {}).get("KHR_lights_punctual", {}).get("light")
        nodes.append(
            GltfNode(
                name=n.get("name", ""),
                children=list(n.get("children", [])),
                mesh=n.get("mesh"),
                camera=n.get("camera"),
                light=light,
                translation=t,
                rotation=r,
                scale=s,
            )
        )

    scenes = [list(s.get("nodes", [])) for s in gltf.get("scenes", [{}])]
    default_scene = int(gltf.get("scene", 0))

    # --- animations ------------------------------------------------------------
    animations: list[list[GltfAnimationChannel]] = []
    for a in gltf.get("animations", []):
        chans = []
        for ch in a.get("channels", []):
            target = ch.get("target", {})
            node = target.get("node")
            path = target.get("path")
            if node is None or path not in ("translation", "rotation", "scale"):
                continue
            sampler = a["samplers"][ch["sampler"]]
            times = bufs.accessor_f32(sampler["input"]).reshape(-1)
            values = bufs.accessor_f32(sampler["output"])
            chans.append(
                GltfAnimationChannel(
                    node=node,
                    path=path,
                    interpolation=sampler.get("interpolation", "LINEAR"),
                    times=times,
                    values=values,
                )
            )
        animations.append(chans)

    return GltfDocument(
        meshes=meshes,
        materials=materials,
        samplers=samplers,
        textures=textures,
        images=images,
        nodes=nodes,
        scenes=scenes,
        default_scene=default_scene,
        lights=lights,
        cameras=cameras,
        animations=animations,
        base_dir=base_dir,
    )
