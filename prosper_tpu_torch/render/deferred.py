"""Deferred shading: G-buffer + clustered lights -> display image.

Counterpart of prosper_tpu/render/deferred.py `shade_deferred` (:22),
`render_deferred` (:108) and `deferred_entry` (:287),
deferred_shading.comp of the reference: decode the G-buffer as
loadFromGbuffer does, the directional light, then clustered point and
spot lights through the tile kernel (K5, ops/shade_tiles.py), the
transparent pass (render/transparent.py) when use_transparent, then the
tone map. The state threads the HiZ pyramid of the culled G-buffer from
frame to frame, as the reference preserve()s it.

Not ported: the post chain (TAA, bloom, DoF, particles) and image-based
lighting raise NotImplementedError naming their ROADMAP.md items.
"""

from __future__ import annotations

import torch

from ..mathx.packing import signed_oct_decode
from ..ops.tonemap import tone_map
from ..scene.convert import camera_tensors, check_device
from .gbuffer import render_gbuffer
from .shading import shade_direct
from .transparent import transparent_pass


def _unsupported(ibl_data=None, use_taa=False, use_bloom=False,
                 use_dof=False, use_particles=False):
    post = [name for name, on in (
        ("use_taa", use_taa), ("use_bloom", use_bloom), ("use_dof", use_dof),
        ("use_particles", use_particles)) if on]
    if post:
        raise NotImplementedError(
            f"{', '.join(post)}: the post chain is ROADMAP.md queue 1, item "
            "'Post chain'"
        )
    if ibl_data is not None:
        raise NotImplementedError(
            "ibl_data needs ops/ibl.py: ROADMAP.md queue 1, items "
            "'Deferred' and 'Post chain'"
        )


def shade_deferred(gbuf: dict, lights: dict, cam: dict, width: int,
                   height: int):
    """Clustered deferred shading of the flat G-buffer -> (R, 3) linear
    color, zero where no surface was hit."""
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
    }
    return shade_direct(surface, lights, cam, gbuf["z_cam"], gbuf["valid"],
                        width, height)


def render_deferred(scene: dict, cam: dict, lut, width: int, height: int,
                    exposure: float = 1.0, contrast: float = 1.0,
                    use_culling: bool = False, prev_hiz: list | None = None,
                    alpha_rounds: int = 0, aniso_taps: int = 1,
                    use_transparent: bool = False):
    """One deferred frame -> (display image (H, W, 3), aux dict: depth
    (H, W), the fresh hiz, draw_stats). The post chain is off."""
    gbuf = render_gbuffer(scene, cam, width, height, use_culling=use_culling,
                          prev_hiz=prev_hiz, alpha_rounds=alpha_rounds,
                          aniso_taps=aniso_taps)
    color = shade_deferred(gbuf, scene["frame"]["lights"], cam, width, height)
    hdr = color.reshape(height, width, 3)
    if use_transparent:
        # ForwardRenderer::recordTransparent's slot (Renderer.cpp:494-500)
        hdr = transparent_pass(scene, cam, hdr, gbuf["z_cam"], width, height)
    img = tone_map(hdr, lut, exposure, contrast)
    aux = {
        "depth": gbuf["depth"].reshape(height, width),
        "hiz": gbuf["hiz"],
        "draw_stats": gbuf["draw_stats"],
    }
    return img, aux


def deferred_entry(*, scene, cam, lut, width, height, device="cuda",
                   exposure=1.0,
                   contrast=1.0, state=None, use_taa=False, use_bloom=False,
                   use_dof=False, use_transparent=False, use_particles=False,
                   ibl_data=None, use_culling=False, alpha_rounds=0,
                   aniso_taps=1, frame_index=0):
    """Deferred mode: one frame -> (image (H, W, 3), state) on `device`
    (the card unless the caller asks for the CPU). `state`
    (None starts anew) carries the preserve()d resources: the depth and
    the HiZ pyramid that the next frame's phase-1 cull tests against,
    and the frame's draw stats. frame_index is accepted for the mode
    table's uniform call; the deferred frame does not read it."""
    _unsupported(ibl_data, use_taa, use_bloom, use_dof, use_particles)
    dev = check_device(scene, device)
    state = dict(state) if state else {}
    lut = torch.as_tensor(lut, dtype=torch.float32, device=dev)
    img, aux = render_deferred(
        scene, camera_tensors(cam, dev), lut, width, height, exposure,
        contrast, use_culling=use_culling, prev_hiz=state.get("hiz"),
        alpha_rounds=alpha_rounds, aniso_taps=aniso_taps,
        use_transparent=use_transparent,
    )
    state.update(aux)
    return img, state
